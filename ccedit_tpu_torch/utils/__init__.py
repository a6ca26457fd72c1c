"""Output filters and evaluation: the invisible watermark (``watermark.py``),
the DeepFloyd safety filter (``safety.py``) and FID (``fid.py``)."""
