"""The quaternion of a rotation matrix, batched over leading dimensions
(from the port's ops/rotations.py). Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def matrix_to_quat(m):
    """Quaternion (w, x, y, z) from rotation matrix (..., 3, 3).

    Branch-free Shepperd-style selection of the numerically best row."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    # Per-branch scale factors t_k; the numerically stable branch maximizes t.
    t0 = 1.0 + tr
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    scales = torch.stack([t0, t1, t2, t3], dim=-1)

    # Candidate quaternions (w, x, y, z), each valid when its t_k > 0.
    c0 = torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1)
    c1 = torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1)
    c2 = torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1)
    c3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, t3], -1)
    candidates = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4 branch, 4 comp)

    # The first maximum, as jnp.argmax picks it (torch.argmax does not
    # promise which of tied maxima it returns).
    best_t = torch.amax(scales, dim=-1, keepdim=True)
    is_max = scales == best_t
    first = (is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)).to(torch.int32)
    choice = torch.argmax(first, dim=-1, keepdim=True)
    q = torch.gather(candidates, -2, choice[..., None].expand(*choice.shape[:-1], 1, 4))[..., 0, :]
    q = q * (0.5 / torch.sqrt(torch.clamp(best_t, min=1e-12)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # Canonicalize sign (w >= 0).
    return torch.where(q[..., :1] < 0, -q, q)


