"""Host-side (numpy, float64) eval geometry.

The port's own copy of epipolar_transformers_tpu/geometry/host.py.  The
reference evaluates triangulation on the CPU in float64 (cv2/pymvg);
mm-level MPJPE parity needs the same precision.  Both RANSACs keep the
`np.random.RandomState(0)` default, so that on the same inputs they draw the
JAX package's hypotheses and give its points bit for bit.
"""

from __future__ import annotations

import numpy as np


def dlt_triangulate_np(pts: np.ndarray, Ps: np.ndarray) -> np.ndarray:
    """Hartley-Zisserman DLT (reference multi_camera_system.py:208-225)."""
    A = []
    for (x, y), P in zip(pts, Ps):
        A.append(x * P[2] - P[0])
        A.append(y * P[2] - P[1])
    _, _, vt = np.linalg.svd(np.asarray(A, dtype=np.float64))
    v = vt[-1]
    return v[:3] / v[3]


def _camera_centers_invA(KRTs: np.ndarray):
    A = KRTs[:, :, :3]
    invA = np.linalg.inv(A)
    centers = -np.einsum("vij,vj->vi", invA, KRTs[:, :, 3])
    return centers, invA


def _point_line_dist(p3d, pts, centers, invA):
    """Distance from p3d to each view's back-projected ray
    (reference triangulation.py:87-95,144-147)."""
    ones = np.ones((len(pts), 1))
    dirs = np.einsum("vij,vj->vi", invA, np.concatenate([pts, ones], 1))
    x1 = dirs + centers
    cro = np.cross(x1 - p3d, centers - p3d)
    return np.linalg.norm(cro, axis=1) / (np.linalg.norm(x1 - centers, axis=1) + 1e-12)


def _dlt_rows(pts: np.ndarray, Ps: np.ndarray) -> np.ndarray:
    """All-view DLT rows per joint: pts (V, J, 2), Ps (V, 3, 4) -> (J, 2V, 4)."""
    rx = pts[..., 0:1] * Ps[:, None, 2] - Ps[:, None, 0]  # (V, J, 4)
    ry = pts[..., 1:2] * Ps[:, None, 2] - Ps[:, None, 1]
    return np.concatenate([rx, ry], axis=0).transpose(1, 0, 2)  # (J, 2V, 4)


def _solve_dlt_batched(A: np.ndarray) -> np.ndarray:
    """Smallest-right-singular-vector solve for a (..., M, 4) row stack, via
    eigh of the 4x4 normal matrix A^T A (equal to the SVD's up to sign, which
    the dehomogenization cancels; f64 absorbs the squared conditioning)."""
    M = np.einsum("...mi,...mj->...ij", A, A)
    _, vecs = np.linalg.eigh(M)
    v = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    with np.errstate(divide="ignore", invalid="ignore"):
        return v[..., :3] / v[..., 3:]


def triangulate_ransac_np(
    pts: np.ndarray,
    KRTs: np.ndarray,
    confs: np.ndarray,
    conf_thres: float = 0.05,
    ransac_thres: float = 3.0,
    n_iter: int = 100,
    refine: bool = False,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """'naive' / 'refine' triangulation (reference triangulation.py:99-232):
    RANSAC over random view pairs with point-to-ray inlier counting; with
    `refine`, a DLT re-fit over the winning inliers (> 1).

    Vectorized over joints x hypotheses (one batched (J, n_iter, 4, 4) solve).
    Distinct random pairs are drawn uniformly via the rank-offset trick (a,
    a+1+U(nsel-1) mod nsel), the distribution of choice(replace=False);
    zero-weighted DLT rows leave A^T A unchanged, so the weighted re-fit
    equals the subset re-fit.
    """
    rng = rng or np.random.RandomState(0)
    pts = np.asarray(pts, dtype=np.float64)
    KRTs = np.asarray(KRTs, dtype=np.float64)
    V, J = confs.shape
    centers, invA = _camera_centers_invA(KRTs)

    sel = np.asarray(confs) > conf_thres  # (V, J)
    selT = sel.T  # (J, V)
    nsel = selT.sum(axis=1)  # (J,)
    active = nsel > 1
    if not active.any():
        return np.zeros((J, 3))

    # per-joint ranks of the selected views (selected first, original order)
    order = np.argsort(~selT, axis=1, kind="stable")  # (J, V)
    n_eff = np.maximum(nsel, 2)[:, None]  # avoid div-by-0 on inactive joints
    a_rank = np.minimum((rng.random_sample((J, n_iter)) * n_eff).astype(int), n_eff - 1)
    off = 1 + np.minimum(
        (rng.random_sample((J, n_iter)) * (n_eff - 1)).astype(int), n_eff - 2
    )
    b_rank = (a_rank + off) % n_eff
    a_view = np.take_along_axis(order, a_rank, axis=1)  # (J, n_iter)
    b_view = np.take_along_axis(order, b_rank, axis=1)

    ptsT = pts.transpose(1, 0, 2)  # (J, V, 2)
    p_a = np.take_along_axis(ptsT, a_view[..., None], axis=1)  # (J, n_iter, 2)
    p_b = np.take_along_axis(ptsT, b_view[..., None], axis=1)
    P_a = KRTs[a_view]  # (J, n_iter, 3, 4)
    P_b = KRTs[b_view]

    def pair_rows(p, P):
        rx = p[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        ry = p[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return np.stack([rx, ry], axis=-2)  # (J, n_iter, 2, 4)

    A = np.concatenate([pair_rows(p_a, P_a), pair_rows(p_b, P_b)], axis=-2)
    p3d = _solve_dlt_batched(A)  # (J, n_iter, 3)

    # point-to-ray distances of every hypothesis against every view
    ph = np.concatenate([pts, np.ones((V, J, 1))], axis=-1)  # (V, J, 3)
    dirs = np.einsum("vij,vkj->vki", invA, ph)  # (V, J, 3)
    x1 = (dirs + centers[:, None]).transpose(1, 0, 2)  # (J, V, 3)
    d1 = x1[:, None] - p3d[:, :, None]  # (J, n_iter, V, 3)
    d2 = centers[None, None] - p3d[:, :, None]
    cro = np.cross(d1, d2)
    denom = np.linalg.norm(x1 - centers[None], axis=-1) + 1e-12  # (J, V)
    dist = np.linalg.norm(cro, axis=-1) / denom[:, None]  # (J, n_iter, V)

    inliers = (dist < ransac_thres) & selT[:, None, :]
    counts = inliers.sum(axis=-1)  # (J, n_iter)
    good = np.isfinite(p3d).all(axis=-1)
    scores = np.where(good, counts, -1)
    best = np.argmax(scores, axis=1)  # first max == earliest hypothesis wins
    best_count = np.take_along_axis(scores, best[:, None], axis=1)[:, 0]
    best3d = np.take_along_axis(p3d, best[:, None, None], axis=1)[:, 0]
    best_inl = np.take_along_axis(inliers, best[:, None, None], axis=1)[:, 0]  # (J, V)

    won = active & (best_count > 0)
    out = np.where(won[:, None], best3d, 0.0)
    if refine:
        refit_mask = won & (best_inl.sum(axis=1) > 1)
        if refit_mask.any():
            A_full = _dlt_rows(pts, KRTs)  # (J, 2V, 4)
            w = np.concatenate([best_inl, best_inl], axis=1)[..., None]  # (J, 2V, 1)
            refit = _solve_dlt_batched(A_full * w)
            out = np.where(refit_mask[:, None], refit, out)
    return out


def triangulate_epipolar_np(
    pts: np.ndarray,
    KRTs: np.ndarray,
    Ks: np.ndarray,
    RTs: np.ndarray,
    confs: np.ndarray,
    corr_pos: np.ndarray,
    other_KRTs: np.ndarray,
    conf_thres: float = 0.05,
    ransac_thres: float = 3.0,
    resize: float = 1.0,
    downsample: int = 4,
    dlt: bool = False,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Epipolar-correspondence-assisted triangulation (reference
    triangulation.py:234-348): when < 2 views clear the confidence threshold,
    the epipolar transformer's correspondence map supplies a second
    observation in the paired view; with `dlt`, confident views go straight
    to DLT; otherwise RANSAC (+DLT re-fit over > 2 inliers).

    corr_pos: (V, h, w, 2) feature-pixel best-match maps.
    """
    rng = rng or np.random.RandomState(0)
    pts = np.asarray(pts, dtype=np.float64)
    KRTs = np.asarray(KRTs, dtype=np.float64)
    other_KRTs = np.asarray(other_KRTs, dtype=np.float64)
    V, J = confs.shape
    centers, invA = _camera_centers_invA(KRTs)
    Ps = np.asarray(Ks, dtype=np.float64) @ np.asarray(RTs, dtype=np.float64)
    out = np.zeros((J, 3))
    for k in range(J):
        conf = confs[:, k]
        sel = conf > conf_thres
        if sel.sum() == 0:
            sel = np.zeros_like(sel)
            sel[np.argmax(conf)] = True
        if sel.sum() == 1:
            # one confident view + its epipolar correspondence (:277-289)
            v = int(np.where(sel)[0][0])
            cand = pts[v, k]
            pix = (cand / resize + 0.5 - downsample / 2.0) / downsample  # coord2pix
            h, w = corr_pos.shape[1:3]
            xi = int(np.clip(pix[0], 0, w - 1))
            yi = int(np.clip(pix[1], 0, h - 1))
            other = corr_pos[v, yi, xi]
            other = (other * downsample + downsample / 2.0 - 0.5) * resize  # pix2coord
            stacked = np.stack([cand, other])
            out[k] = dlt_triangulate_np(stacked, np.stack([KRTs[v], other_KRTs[v]]))
            continue
        sel_idx = np.where(sel)[0]
        cands = pts[sel_idx, k]
        if dlt:
            out[k] = dlt_triangulate_np(cands, Ps[sel_idx])
            continue
        best_acc, best3d, best_inliers = 0, np.zeros(3), []
        for _ in range(100):
            a, b = rng.choice(len(sel_idx), 2, replace=False)
            p3d = dlt_triangulate_np(cands[[a, b]], KRTs[sel_idx][[a, b]])
            if not np.isfinite(p3d).all():
                continue
            d = _point_line_dist(p3d, cands, centers[sel_idx], invA[sel_idx])
            inliers = np.where(d < ransac_thres)[0]
            if len(inliers) > best_acc:
                best_acc, best3d, best_inliers = len(inliers), p3d, inliers
        if len(best_inliers) > 2:
            best3d = dlt_triangulate_np(cands[best_inliers], Ps[sel_idx][best_inliers])
        out[k] = best3d
    return out


def triangulate_pymvg_np(
    pts: np.ndarray,
    Ks: np.ndarray,
    RTs: np.ndarray,
    confs: np.ndarray,
    conf_thres: float = 0.05,
) -> np.ndarray:
    """Adaptive confidence-thresholded DLT (reference triangulation.py:400-441).

    Args:
        pts: (V, J, 2); Ks: (V, 3, 3); RTs: (V, 3, 4); confs: (V, J).
    Returns:
        (J, 3) float64.
    """
    pts = np.asarray(pts, dtype=np.float64)
    Ps = np.asarray(Ks, dtype=np.float64) @ np.asarray(RTs, dtype=np.float64)
    confs = np.asarray(confs)
    V, J = confs.shape

    # vectorized adaptive threshold decay (step 0.05 until >= 2 views pass or
    # thresh < -1, where every view passes since confidences are positive),
    # then one batched masked DLT over all joints: zero-weighted rows leave
    # A^T A unchanged, so the masked solve equals the subset solve.
    n_steps = int(np.ceil((conf_thres + 1.0) / 0.05)) + 2
    threshs = conf_thres - 0.05 * np.arange(n_steps)  # last entries < -1
    passing = confs.T[:, None, :] > threshs[None, :, None]  # (J, S, V)
    ok = passing.sum(axis=-1) > 1  # (J, S)
    first = np.argmax(ok, axis=1)
    idx = np.where(ok.any(axis=1), first, n_steps - 1)
    sel = np.take_along_axis(passing, idx[:, None, None], axis=1)[:, 0]  # (J, V)

    A = _dlt_rows(pts, Ps)  # (J, 2V, 4)
    w = np.concatenate([sel, sel], axis=1)[..., None].astype(np.float64)
    return _solve_dlt_batched(A * w)
