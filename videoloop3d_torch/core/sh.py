"""Real spherical-harmonics bases (degrees 0-4) for view-dependent color
(counterpart of ``videoloop3d_tpu/core/sh.py``; the svox2 / PlenOctrees
constants, ref utils_mpi.py:334-412), used by the ``rgb_sh`` and
``rgba_sh`` texel decoders."""
from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh_bases(basis_dim: int, dirs):
    """The first basis_dim (1, 4, 9, 16 or 25) bases at the unit
    directions dirs (..., 3).  Returns (..., basis_dim), in the JAX
    function's order of operations."""
    out = [torch.full(dirs.shape[:-1], _C0, dtype=dirs.dtype,
                      device=dirs.device)]
    if basis_dim > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-_C1 * y, _C1 * z, -_C1 * x]
        if basis_dim > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2 * zz - xx - yy),
                    _C2[3] * xz, _C2[4] * (xx - yy)]
            if basis_dim > 9:
                out += [_C3[0] * y * (3 * xx - yy),
                        _C3[1] * xy * z,
                        _C3[2] * y * (4 * zz - xx - yy),
                        _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                        _C3[4] * x * (4 * zz - xx - yy),
                        _C3[5] * z * (xx - yy),
                        _C3[6] * x * (xx - 3 * yy)]
                if basis_dim > 16:
                    out += [_C4[0] * xy * (xx - yy),
                            _C4[1] * yz * (3 * xx - yy),
                            _C4[2] * xy * (7 * zz - 1),
                            _C4[3] * yz * (7 * zz - 3),
                            _C4[4] * (zz * (35 * zz - 30) + 3),
                            _C4[5] * xz * (7 * zz - 3),
                            _C4[6] * (xx - yy) * (7 * zz - 1),
                            _C4[7] * xz * (xx - 3 * yy),
                            _C4[8] * (xx * (xx - 3 * yy)
                                      - yy * (3 * xx - yy))]
    return torch.stack(out[:basis_dim], dim=-1)
