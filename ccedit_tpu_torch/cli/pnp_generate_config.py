"""Write the pnp-diffusers YAML of the automatic centre-frame editing
pipeline (port of ``ccedit_tpu/cli/pnp_generate_config.py``).

    python -m ccedit_tpu_torch.cli.pnp_generate_config --image_path centre.png \\
        --prompt "a robot bear" --save_path pnp.yaml

The config is flat (strings, numbers), so the port writes its YAML itself
(``flat_yaml``, PyYAML's ``safe_dump`` layout: keys sorted, strings quoted
where YAML would read them otherwise); ``yaml.safe_load`` of it equals the
dict.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Dict

# plain scalars YAML 1.1 would read as something other than the string
_SPECIAL = re.compile(r"^(?:[-+]?(?:\d[\d_]*)?\.?\d[\d_]*(?:[eE][-+]?\d+)?|[-+]?\.(?:inf|Inf|INF)"
                      r"|\.(?:nan|NaN|NAN)|0x[0-9a-fA-F_]+|0o?[0-7_]+|[-+]?\d[\d_]*(?::[0-5]?\d)+"
                      r"|y|Y|yes|Yes|YES|n|N|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON"
                      r"|off|Off|OFF|null|Null|NULL|~|\d{4}-\d\d?-\d\d?.*)$")


def _scalar(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):  # PyYAML's representer
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    s = str(value)
    plain = (s and s == s.strip() and not _SPECIAL.match(s) and s[0] not in "!&*-?:,[]{}#|>@`\"'%"
             and ": " not in s and " #" not in s and not s.endswith(":") and s.isprintable())
    return s if plain else json.dumps(s)


def flat_yaml(cfg: Dict) -> str:
    """A flat dict of strings, numbers and booleans as YAML, keys sorted."""
    return "".join(f"{k}: {_scalar(v)}\n" for k, v in sorted(cfg.items()))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", type=str, required=True, help="center keyframe png")
    p.add_argument("--prompt", type=str, required=True, help="edit prompt")
    p.add_argument("--save_path", type=str, required=True, help="output yaml path")
    p.add_argument("--output_dir", type=str, default="outputs/pnp")
    p.add_argument("--latents_path", type=str, default="latents")
    p.add_argument("--negative_prompt", type=str, default="ugly, blurry, low res, unrealistic")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--pnp_attn_t", type=float, default=0.5)
    p.add_argument("--pnp_f_t", type=float, default=0.8)
    return p


def main(argv=None) -> Path:
    args = parser().parse_args(argv)
    cfg = {
        "seed": 1,
        "device": "cuda",
        "output_path": args.output_dir,
        "image_path": args.image_path,
        "latents_path": args.latents_path,
        "sd_version": "1.5",
        "guidance_scale": args.guidance_scale,
        "n_timesteps": args.steps,
        "prompt": args.prompt,
        "negative_prompt": args.negative_prompt,
        "pnp_attn_t": args.pnp_attn_t,
        "pnp_f_t": args.pnp_f_t,
    }
    out = Path(args.save_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(flat_yaml(cfg))
    print(f"wrote pnp config to {out}")
    return out


if __name__ == "__main__":
    main()
