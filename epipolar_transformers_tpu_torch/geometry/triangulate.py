"""Multi-view triangulation, batched, in torch on the tensors' device.

Port of epipolar_transformers_tpu/geometry/triangulate.py (reference
vision/triangulation.py and the vendored pymvg DLT,
vision/multi_camera_system.py:199-225): one batched SVD or masked reduction
where the reference loops over joints and RANSAC iterations.  The eval
engine keeps its f64 host copies (geometry/host.py, engine/tester.py); this
is the batched library version that the JAX package ships beside them.

  * `dlt_triangulate`: Hartley-Zisserman find3d, rows x P[2] - P[0] and
    y P[2] - P[1], the smallest right singular vector (`torch.linalg.svd`);
    masked-out views give zero rows, which leave A^T A and so the null
    vector unchanged.
  * `triangulate_ransac` / `triangulate_refine`: the 'naive' mode and its
    DLT re-fit over the winning inliers (reference triangulation.py:99-232).
    The candidate pairs come from `ransac_pairs`, drawn from a
    `torch.Generator` (the JAX package draws with `jax.random`, the
    reference with Python's `random`; the reference's results tolerate the
    seed), and are scored by `ransac_score`; a caller may hand its own
    draws to the triangulations (`pairs`).
  * `triangulate_pymvg`: the adaptive confidence threshold (lowered by 0.05
    until two views pass, reference triangulation.py:426-435), then a
    masked all-view DLT.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .camera import camera_center

RANSAC_ITER = 100  # reference triangulation.py:97


def _dlt_A(pts: torch.Tensor, Ps: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., V, 2) points and (..., V, 3, 4) cameras -> the (..., 2V, 4) DLT
    rows, x and y of each view interleaved."""
    rx = pts[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]
    ry = pts[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]
    A = torch.stack([rx, ry], dim=-2).flatten(-3, -2)
    if weights is not None:
        A = A * weights.to(A.dtype).repeat_interleave(2, dim=-1)[..., None]
    return A


def dlt_triangulate(pts: torch.Tensor, Ps: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear (SVD) triangulation: (..., V, 2) pixel observations, (..., V,
    3, 4) projections and an optional (..., V) 0/1 view mask -> (..., 3)."""
    _, _, vh = torch.linalg.svd(_dlt_A(pts, Ps, weights))
    v = vh[..., -1, :]
    return v[..., :3] / v[..., 3:]


def dlt_triangulate_pair(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor) -> torch.Tensor:
    """Two-view homogeneous DLT (cv2.triangulatePoints, then dehomogenized;
    reference triangulation.py:139-141,156-160), batched over leading dims."""
    return dlt_triangulate(torch.stack([p1, p2], -2), torch.stack([P1, P2], -3))


def point_line_distances(p3d: torch.Tensor, pts: torch.Tensor, KRTs: torch.Tensor) -> torch.Tensor:
    """Distance from (..., 3) points to each view's back-projected ray of
    its (..., V, 2) observation, (..., V, 3, 4) cameras -> (..., V)
    (reference triangulation.py:87-95,144-147: the ray through the camera
    center c and x1 = A^-1 (u, v, 1) + c)."""
    A = KRTs[..., :3]
    centers = camera_center(KRTs)
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    x1 = torch.linalg.solve(A, homo[..., None])[..., 0] + centers
    p = p3d[..., None, :]
    cro = torch.linalg.cross(x1 - p, centers - p, dim=-1)
    return torch.linalg.norm(cro, dim=-1) / (torch.linalg.norm(x1 - centers, dim=-1) + 1e-12)


def ransac_pairs(selected: torch.Tensor, n_iter: int = RANSAC_ITER,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate view pairs for each joint: (J, V) 0/1 selection -> a, b,
    each (J, n_iter) view indices, drawn uniformly over the selected views
    (over all views where a joint has none; such a joint is zero anyway),
    on the generator's device, returned on `selected`'s."""
    dev = generator.device if generator is not None else torch.device("cpu")
    sel = selected.to(dev, torch.float64)
    probs = sel / sel.sum(-1, keepdim=True).clamp(min=1) + 1e-30
    a = torch.multinomial(probs, n_iter, replacement=True, generator=generator)
    b = torch.multinomial(probs, n_iter, replacement=True, generator=generator)
    return a.to(selected.device), b.to(selected.device)


def ransac_score(pts: torch.Tensor, KRTs: torch.Tensor, selected: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, ransac_thres: float = 3.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the pairs (a, b) of every joint at once.

    Args:
        pts: (V, J, 2); KRTs: (V, 3, 4); selected: (J, V) 0/1.
        a, b: (J, n_iter) view indices.
    Returns:
        (J, 3) best point, (J, V) its inliers, (J,) inlier count: the first
        pair with the most inliers among the valid ones (a != b, a finite
        point), zero where no pair has an inlier (the reference replaces
        its best only when the count is above 0).
    """
    jp = pts.transpose(0, 1)  # (J, V, 2)
    J = jp.shape[0]
    rows = torch.arange(J, device=pts.device)[:, None]
    p3ds = dlt_triangulate_pair(KRTs[a], KRTs[b], jp[rows, a], jp[rows, b])  # (J, n, 3)
    dists = point_line_distances(p3ds, jp[:, None], KRTs)  # (J, n, V)
    inliers = (dists < ransac_thres) & (selected > 0)[:, None, :]
    counts = inliers.sum(-1)
    good = (a != b) & torch.isfinite(p3ds).all(-1)
    scores = torch.where(good, counts, torch.full_like(counts, -1))
    best = scores.argmax(-1)  # the first maximum: the earliest pair, as the reference's `>`
    best_count = scores.gather(1, best[:, None])[:, 0]
    won = best_count > 0
    take = best[:, None, None]
    best3d = p3ds.gather(1, take.expand(J, 1, 3))[:, 0]
    best_inliers = inliers.gather(1, take.expand(J, 1, inliers.shape[-1]))[:, 0]
    best3d = torch.where(won[:, None], best3d, torch.zeros_like(best3d))
    best_inliers = best_inliers & won[:, None]
    return best3d, best_inliers, best_count.clamp(min=0)


def _ransac(pts, KRTs, confs, generator, conf_thres, ransac_thres, n_iter, pairs, refine: bool):
    selected = (confs > conf_thres).transpose(0, 1).to(pts.dtype)  # (J, V)
    a, b = pairs if pairs is not None else ransac_pairs(selected, n_iter, generator)
    p3d, inliers, count = ransac_score(pts, KRTs, selected, a, b, ransac_thres)
    if refine:
        refit = dlt_triangulate(pts.transpose(0, 1), KRTs.expand(pts.shape[1], *KRTs.shape),
                                inliers.to(pts.dtype))
        p3d = torch.where((count > 1)[:, None], refit, p3d)
    return torch.where((selected.sum(-1) > 1)[:, None], p3d, torch.zeros_like(p3d))


def triangulate_ransac(pts: torch.Tensor, KRTs: torch.Tensor, confs: torch.Tensor,
                       generator: Optional[torch.Generator] = None, conf_thres: float = 0.05,
                       ransac_thres: float = 3.0, n_iter: int = RANSAC_ITER,
                       pairs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """'naive' triangulation (reference triangulation.py:99-154): (V, J, 2)
    points, (V, 3, 4) cameras, (V, J) confidences -> (J, 3) world points,
    zero where fewer than two views pass conf_thres.  `pairs`: the (J,
    n_iter) candidate pairs, else drawn by `ransac_pairs` from `generator`."""
    return _ransac(pts, KRTs, confs, generator, conf_thres, ransac_thres, n_iter, pairs, False)


def triangulate_refine(pts: torch.Tensor, KRTs: torch.Tensor, confs: torch.Tensor,
                       generator: Optional[torch.Generator] = None, conf_thres: float = 0.05,
                       ransac_thres: float = 3.0, n_iter: int = RANSAC_ITER,
                       pairs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """RANSAC, then a DLT over the winning inliers where there are more than
    one (reference triangulation.py:162-232); arguments as
    `triangulate_ransac`."""
    return _ransac(pts, KRTs, confs, generator, conf_thres, ransac_thres, n_iter, pairs, True)


def adaptive_selection(conf: torch.Tensor, conf_thres: float, step: float = 0.05) -> torch.Tensor:
    """(..., V) confidences -> (..., V) views above the first threshold,
    conf_thres lowered by `step`, that passes two views (reference
    triangulation.py:426-435, which stops once the threshold is below -1)."""
    n_steps = int((conf_thres + 1.0) / step) + 2
    threshs = conf_thres - step * torch.arange(n_steps, dtype=conf.dtype, device=conf.device)
    counts = (conf[..., None, :] > threshs[:, None]).sum(-1)  # (..., n_steps)
    ok = counts > 1
    first = ok.to(torch.int8).argmax(-1)
    idx = torch.where(ok.any(-1), first, torch.full_like(first, n_steps - 1))
    return conf > threshs[idx][..., None]


def triangulate_pymvg(pts: torch.Tensor, Ks: torch.Tensor, RTs: torch.Tensor, confs: torch.Tensor,
                      conf_thres: float = 0.05) -> torch.Tensor:
    """The reference 'pymvg' mode (reference triangulation.py:400-441,
    multi_camera_system.py:199-225): its cameras have no distortion and P =
    K RT, so this is the adaptive selection and a masked DLT.  (V, J, 2)
    points, (V, 3, 3) Ks, (V, 3, 4) RTs, (V, J) confidences -> (J, 3)."""
    Ps = Ks @ RTs
    sel = adaptive_selection(confs.transpose(0, 1), conf_thres)  # (J, V)
    J = pts.shape[1]
    return dlt_triangulate(pts.transpose(0, 1), Ps.expand(J, *Ps.shape), sel.to(pts.dtype))
