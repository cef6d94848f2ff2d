"""SVFID: spatially-varying Frechet distance on C3D features (counterpart
of ``videoloop3d_tpu/eval/svfid.py``).

Parity: reference evaluations/SVFID.py + C3D_model.py: a conv-only C3D
forward (5 conv blocks with 3-D max-pools), then a per-spatial-location
batched Frechet distance between feature distributions over time.  The
C3D weights (``c3d.pickle``) are not shipped by the reference either: the
metric is gated on a local weights file named by ``weights_path`` or
``VL3D_C3D_WEIGHTS`` (npz with conv{i}/w, conv{i}/b in OIDHW layout, or a
torch pickle converted with `convert_torch_weights`).  The convolutions
run on the model's device in full f32 (`lpips.full_f32`); the matrix
square roots run on the host (scipy), as in the JAX package.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from videoloop3d_torch.eval.lpips import full_f32

# (out_channels, pool (d, h, w), pool padding) per conv stage; all conv
# kernels 3x3x3 pad 1.  The final pool pads (0, 1, 1) like the
# reference's pool5 (ref C3D_model.py:29).
_C3D_CFG = [(64, (1, 2, 2), None), (128, (2, 2, 2), None),
            (256, None, None), (256, (2, 2, 2), None),
            (512, None, None), (512, (2, 2, 2), None),
            (512, None, None), (512, (2, 2, 2), (0, 1, 1))]


def convert_torch_weights(c3d_pickle, out_npz):
    sd = torch.load(c3d_pickle, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    conv_names = [k for k in sd if k.endswith(".weight")
                  and sd[k].dim() == 5]
    for i, name in enumerate(sorted(conv_names)):
        out[f"conv{i}/w"] = sd[name].numpy()
        out[f"conv{i}/b"] = sd[name[:-6] + "bias"].numpy()
    np.savez(out_npz, **out)
    return out_npz


class C3DFeatures:
    """The C3D feature extractor on `device`, from the weights file if it
    exists."""

    def __init__(self, weights_path=None, *, device):
        self.device = torch.device(device)
        self.weights = None
        path = weights_path or os.environ.get("VL3D_C3D_WEIGHTS", "")
        if path and os.path.exists(path):
            z = np.load(path)
            self.weights = {k: torch.as_tensor(z[k], device=self.device)
                            for k in z.files}

    @property
    def available(self):
        return self.weights is not None

    def __call__(self, video):
        """video: (B, 3, F, H, W) -> conv5b features (numpy)."""
        if not self.available:
            raise RuntimeError("C3D weights unavailable; set "
                               "VL3D_C3D_WEIGHTS")
        h = torch.as_tensor(np.asarray(video, np.float32), device=self.device)
        with torch.inference_mode(), full_f32():
            for i, (_, pool, ppad) in enumerate(_C3D_CFG):
                h = F.relu(F.conv3d(h, self.weights[f"conv{i}/w"],
                                    self.weights[f"conv{i}/b"], padding=1))
                if pool is not None:
                    h = F.max_pool3d(h, pool, pool, padding=ppad or 0)
            return h.cpu().numpy()


def batched_frechet(mu1, s1, mu2, s2, eps=1e-6):
    """Parity: evaluations/SVFID.py:11-33."""
    diff = mu1 - mu2
    offset = np.eye(s1.shape[1])[None] * eps
    mats = (s1 + offset) @ (s2 + offset)
    covmean = np.array([linalg.sqrtm(m, disp=False)[0] for m in mats])
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    tr = np.trace(covmean, axis1=1, axis2=2)
    return ((diff * diff).sum(-1) + np.trace(s1, axis1=1, axis2=2)
            + np.trace(s2, axis1=1, axis2=2) - 2 * tr)


def svfid(net: C3DFeatures, src, tar):
    """src/tar: (F, H, W, 3) in [0, 255].  Per-spatial-location Frechet
    distance on C3D features, averaged (ref SVFID.py:30-65)."""
    def feats(v):
        x = np.moveaxis(np.asarray(v, np.float32), -1, 0)[None]
        f = net(x)[0][:50]                  # first 50 channels: (50,F',H',W')
        f = f.transpose(2, 3, 1, 0)         # (H', W', F', 50)
        return f.reshape(-1, f.shape[2], f.shape[3])    # (H'W', F', 50)

    fs = feats(src)
    ft = feats(tar)

    def mean_cov(p):
        mu = p.mean(axis=1)
        d = p - mu[:, None]
        cov = np.einsum("bnd,bne->bde", d, d) / (p.shape[1] - 1)
        return mu, cov

    mu1, c1 = mean_cov(fs)
    mu2, c2 = mean_cov(ft)
    return float(batched_frechet(mu1, c1, mu2, c2).mean())
