"""OpenPose body pose (port of ``ccedit_tpu/conditioning/annotators/
openpose.py``): the CMU CPM body network on the card, peak finding, limb
assembly, person grouping and drawing on the host.

The network (``BodyPoseModel``) is a VGG-19-style trunk and six stages, each
predicting 38 part-affinity-field (PAF) and 19 heatmap channels at stride 8,
every refinement stage re-reading [PAF, heatmap, trunk].
``bodypose_from_state_dict`` reads ``body_pose_model.pth`` with its raw
keys (``conv1_1.weight``) or module-prefixed ones (``model0.conv1_1.weight``).

Per frame, as the JAX package's ``BodyEstimator`` (one scale, 0.5, box 368,
stride 8, pad value 128): the BGR frame in 0..255 is resized by
0.5 * 368 / H (cv2's INTER_AREA below 1, INTER_CUBIC above), padded to a
multiple of 8 with 128, mapped to x / 256 - 0.5; the maps are upsampled x8
(INTER_LINEAR), cropped and resized to the frame (INTER_LINEAR).  The
resizes are ``imgproc``'s cv2 weight matrices, applied on the frames'
device.  On the host: peaks of each heatmap after scipy's 2-D
``gaussian_filter`` (sigma 3; the JAX package implements the original
openpose blur, not the reference's 1-D rewrite), greedy PAF limb matching,
person grouping, and the canvas (limb ellipses at 0.6, joint circles),
drawn with ``imgproc``.  The hint is 1 - canvas / 255 mapped to [-1, 1].
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import imgproc

# (name, out_channels, kernel, pool_before) per trunk layer; VGG19-CPM trunk
_TRUNK: Sequence[Tuple[str, int, int, bool]] = (
    ("conv1_1", 64, 3, False), ("conv1_2", 64, 3, False),
    ("conv2_1", 128, 3, True), ("conv2_2", 128, 3, False),
    ("conv3_1", 256, 3, True), ("conv3_2", 256, 3, False),
    ("conv3_3", 256, 3, False), ("conv3_4", 256, 3, False),
    ("conv4_1", 512, 3, True), ("conv4_2", 512, 3, False),
    ("conv4_3_CPM", 256, 3, False), ("conv4_4_CPM", 128, 3, False),
)
_BRANCHES = (("L1", 38), ("L2", 19))


def _layers() -> List[Tuple[str, int, int, int]]:
    """(name, in, out, kernel) of every conv, in execution order."""
    out, cin = [], 3
    for name, ch, k, _ in _TRUNK:
        out.append((name, cin, ch, k))
        cin = ch
    for branch, n in _BRANCHES:
        c = 128
        for i in range(1, 4):
            out.append((f"conv5_{i}_CPM_{branch}", c, 128, 3))
        out += [(f"conv5_4_CPM_{branch}", 128, 512, 1), (f"conv5_5_CPM_{branch}", 512, n, 1)]
    for s in range(2, 7):
        for branch, n in _BRANCHES:
            c = 38 + 19 + 128
            for i in range(1, 6):
                out.append((f"Mconv{i}_stage{s}_{branch}", c, 128, 7))
                c = 128
            out += [(f"Mconv6_stage{s}_{branch}", 128, 128, 1),
                    (f"Mconv7_stage{s}_{branch}", 128, n, 1)]
    return out


class BodyPoseModel(nn.Module):
    """(N, 3, H, W) preprocessed (x / 256 - 0.5) -> (PAF (N, 38, h, w),
    heatmap (N, 19, h, w)) at stride 8."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict({name: nn.Conv2d(cin, cout, k, padding=k // 2)
                                    for name, cin, cout, k in _layers()})

    def forward(self, x):
        c = self.convs
        for name, _, _, pool in _TRUNK:
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(c[name](x))
        trunk = x

        def stage1(branch):
            y = trunk
            for i in range(1, 5):
                y = F.relu(c[f"conv5_{i}_CPM_{branch}"](y))
            return c[f"conv5_5_CPM_{branch}"](y)

        paf, heat = stage1("L1"), stage1("L2")
        for s in range(2, 7):
            inp = torch.cat([paf, heat, trunk], dim=1)

            def refine(branch, inp=inp, s=s):
                y = inp
                for i in range(1, 7):
                    y = F.relu(c[f"Mconv{i}_stage{s}_{branch}"](y))
                return c[f"Mconv7_stage{s}_{branch}"](y)

            paf, heat = refine("L1"), refine("L2")
        return paf, heat


def bodypose_from_state_dict(sd: Dict[str, torch.Tensor]) -> BodyPoseModel:
    flat = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0].startswith("model"):
            parts = parts[1:]
        flat["convs." + ".".join(parts)] = v.float()
    model = BodyPoseModel()
    model.load_state_dict(flat)
    return model.eval()


# ---------------------------------------------------------------------------
# the network's maps, on the frames' device
# ---------------------------------------------------------------------------

def _resized(x: torch.Tensor, mats) -> torch.Tensor:
    """(N, H, W, C) fp32 through a (dst_h, H), (dst_w, W) pair of weights."""
    my, mx = (torch.as_tensor(m, dtype=torch.float32, device=x.device) for m in mats)
    return torch.einsum("ah,nhwc,bw->nabc", my, x, mx)


def openpose_maps(model: BodyPoseModel,
                  frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) RGB in [-1, 1] -> heatmaps (N, H, W, 19) and PAFs
    (N, H, W, 38), fp32, at the frame size."""
    n, h, w = frames.shape[:3]
    x255 = ((frames.float() + 1.0) * 127.5).clamp(0.0, 255.0).flip(-1)
    scale = 0.5 * 368.0 / h
    interp = imgproc.INTER_AREA if scale < 1 else imgproc.INTER_CUBIC
    resized = _resized(x255, imgproc.resize_matrices((h, w), fx=scale, fy=scale,
                                                     interpolation=interp))
    rh, rw = resized.shape[1:3]
    ph, pw = rh + (8 - rh % 8) % 8, rw + (8 - rw % 8) % 8
    padded = F.pad(resized, (0, 0, 0, pw - rw, 0, ph - rh), value=128.0)
    dtype = next(model.parameters()).dtype
    paf, heat = model((padded / 256.0 - 0.5).permute(0, 3, 1, 2).to(dtype))
    maps = torch.cat([heat, paf], dim=1).float().permute(0, 2, 3, 1)
    up = imgproc.resize_matrices(maps.shape[1:3], dsize=(pw, ph),
                                 interpolation=imgproc.INTER_LINEAR)
    maps = _resized(maps, up)[:, :rh, :rw]
    maps = _resized(maps, imgproc.resize_matrices((rh, rw), dsize=(w, h),
                                                  interpolation=imgproc.INTER_LINEAR))
    return maps[..., :19], maps[..., 19:]


# ---------------------------------------------------------------------------
# host-side assembly (the original openpose semantics)
# ---------------------------------------------------------------------------

LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
           [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
           [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
           [45, 46]]
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85]]


def find_peaks(heatmap: np.ndarray, thre1: float = 0.1):
    """(H, W, 19) -> per part, a list of (x, y, score, id): 4-neighbour
    local maxima of the sigma-3 smoothed map above ``thre1``."""
    from scipy.ndimage import gaussian_filter

    all_peaks: List[List[Tuple]] = []
    counter = 0
    for part in range(18):
        map_ori = heatmap[:, :, part]
        smoothed = gaussian_filter(map_ori, sigma=3)
        left = np.zeros_like(smoothed)
        left[1:, :] = smoothed[:-1, :]
        right = np.zeros_like(smoothed)
        right[:-1, :] = smoothed[1:, :]
        up = np.zeros_like(smoothed)
        up[:, 1:] = smoothed[:, :-1]
        down = np.zeros_like(smoothed)
        down[:, :-1] = smoothed[:, 1:]
        binary = ((smoothed >= left) & (smoothed >= right) & (smoothed >= up)
                  & (smoothed >= down) & (smoothed > thre1))
        ys, xs = np.nonzero(binary)
        peaks = [(int(x), int(y), float(map_ori[y, x]), counter + i)
                 for i, (y, x) in enumerate(zip(ys, xs))]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def assemble_limbs(all_peaks, paf: np.ndarray, img_h: int, thre2: float = 0.05,
                   mid_num: int = 10):
    """Greedy PAF limb matching.  paf: (H, W, 38)."""
    connection_all, special_k = [], []
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, [x - 19 for x in MAP_IDX[k]]]
        cand_a = all_peaks[LIMB_SEQ[k][0] - 1]
        cand_b = all_peaks[LIMB_SEQ[k][1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.asarray(b[:2], np.float64) - np.asarray(a[:2], np.float64)
                norm = max(0.001, math.hypot(vec[0], vec[1]))
                vec = vec / norm
                xs = np.linspace(a[0], b[0], mid_num)
                ys = np.linspace(a[1], b[1], mid_num)
                vx = np.array([score_mid[int(round(ys[t])), int(round(xs[t])), 0]
                               for t in range(mid_num)])
                vy = np.array([score_mid[int(round(ys[t])), int(round(xs[t])), 1]
                               for t in range(mid_num)])
                score_mid_pts = vx * vec[0] + vy * vec[1]
                score_prior = score_mid_pts.mean() + min(0.5 * img_h / norm - 1, 0)
                if (score_mid_pts > thre2).sum() > 0.8 * mid_num and score_prior > 0:
                    candidates.append([i, j, score_prior, score_prior + a[2] + b[2]])
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = np.zeros((0, 5))
        for i, j, s, _ in candidates:
            if i not in connection[:, 3] and j not in connection[:, 4]:
                connection = np.vstack([connection, [cand_a[i][3], cand_b[j][3], s, i, j]])
                if len(connection) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def merge_subsets(all_peaks, connection_all, special_k):
    """Person grouping.  Returns (candidate (n, 4): x, y, score, id;
    subset (m, 20): 18 part ids, score, count)."""
    subset = -1 * np.ones((0, 20))
    candidate = np.array([item for sublist in all_peaks for item in sublist], dtype=np.float64)
    if candidate.size == 0:
        candidate = candidate.reshape(0, 4)
    for k in range(len(MAP_IDX)):
        if k in special_k:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        index_a, index_b = np.array(LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][index_a] == part_as[i] or subset[j][index_b] == part_bs[i]:
                    if found < 2:
                        subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][index_b] != part_bs[i]:
                    subset[j][index_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][index_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[index_a] = part_as[i]
                row[index_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (candidate[connection_all[k][i, :2].astype(int), 2].sum()
                           + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def draw_bodypose(canvas: np.ndarray, candidate, subset) -> np.ndarray:
    """Limb ellipses, the canvas scaled by 0.6, then joint circles;
    candidate x/y normalised to [0, 1]."""
    h, w = canvas.shape[:2]
    candidate = np.asarray(candidate)
    stickwidth = 4
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            y = candidate[index.astype(int), 0] * float(w)
            x = candidate[index.astype(int), 1] * float(h)
            mx, my = x.mean(), y.mean()
            length = math.hypot(x[0] - x[1], y[0] - y[1])
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            polygon = imgproc.ellipse2Poly((int(my), int(mx)), (int(length / 2), stickwidth),
                                           int(angle), 0, 360, 1)
            imgproc.fill_convex_poly(canvas, polygon, COLORS[i])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            imgproc.circle(canvas, (int(x * w), int(y * h)), 4, COLORS[i])
    return canvas


def pose_canvas(heat: np.ndarray, paf: np.ndarray) -> np.ndarray:
    """One frame's (H, W, 19) heatmap and (H, W, 38) PAF -> its (H, W, 3)
    uint8 pose canvas."""
    h, w = heat.shape[:2]
    all_peaks = find_peaks(heat)
    connection_all, special_k = assemble_limbs(all_peaks, paf, h)
    candidate, subset = merge_subsets(all_peaks, connection_all, special_k)
    if len(candidate):
        candidate = candidate.copy()
        candidate[:, 0] /= float(w)
        candidate[:, 1] /= float(h)
    return draw_bodypose(np.zeros((h, w, 3), dtype=np.uint8), candidate, subset)


def detect_openpose(model: BodyPoseModel, frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) RGB in [-1, 1] -> inverted pose canvases (N, H, W, 3) in
    [-1, 1], fp32, on the frames' device."""
    heat, paf = openpose_maps(model, frames)
    heat, paf = heat.cpu().numpy(), paf.cpu().numpy()
    poses = np.stack([pose_canvas(heat[i], paf[i]) for i in range(len(heat))])
    poses = torch.from_numpy(poses).to(frames.device).float() / 255.0
    return (1.0 - poses) * 2.0 - 1.0
