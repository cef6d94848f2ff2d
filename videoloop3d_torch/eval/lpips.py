"""LPIPS perceptual metric: the three backbones and the linear heads
(counterpart of ``videoloop3d_tpu/eval/lpips.py``).

Parity: reference evaluations/lpips/ (the vendored richzhang LPIPS):
``alex`` (5 taps), ``vgg`` (vgg16, 5 taps) and ``squeeze``
(squeezenet1.1, 7 taps), pretrained_networks.py:6-130, lpips.py:158-181.
The weights are a local ``.npz`` made by `convert_torch_weights`, named by
``weights_path`` or ``VL3D_LPIPS_WEIGHTS``, with the JAX package's keys;
nothing is downloaded.  Without weights the metric is unavailable
(`LPIPS.available`) and the evaluator reports NaN.

The backbones are `F.conv2d` and `F.max_pool2d` on the model's device.
On the card the convolutions run in full f32: cuDNN's TF32, PyTorch's
default for convolutions, is turned off around them (`full_f32`), so the
metric does not depend on the device.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet feature config: (out_c, kernel, stride, pad)
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}          # maxpool after stages 0 and 1

# torchvision VGG16: 13 k3/s1/p1 convs in 5 stages, 2x2 pool between
# stages, taps after each stage's last relu (pretrained_networks.py:108-117)
_VGG_STAGES = [[64, 64], [128, 128], [256, 256, 256],
               [512, 512, 512], [512, 512, 512]]
_VGG_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

# torchvision SqueezeNet1.1: conv0 k3/s2 + 8 fire modules; ceil-mode
# 3x2 maxpools before fires 0, 2 and 4; taps per
# pretrained_networks.py:18-31 (7 slices)
_SQUEEZE_FIRE_IDS = [3, 4, 6, 7, 9, 10, 11, 12]
_SQUEEZE_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128),
                  (48, 192), (48, 192), (64, 256), (64, 256)]
_SQUEEZE_POOL_BEFORE_FIRE = {0, 2, 4}
_SQUEEZE_TAP_AFTER_FIRE = {1, 3, 4, 5, 6, 7}   # plus the conv0 tap

_CHNS = {"alex": [64, 192, 384, 256, 256],
         "vgg": [64, 128, 256, 512, 512],
         "squeeze": [64, 128, 256, 384, 384, 512, 512]}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and matrix products in full f32 (no TF32)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def convert_torch_weights(backbone_pth, lpips_pth, out_npz, net="alex"):
    """Convert a torchvision backbone state_dict (alexnet / vgg16 /
    squeezenet1_1, chosen by `net`) and the lpips linear heads into the
    .npz this module loads (the JAX package's keys)."""
    sd = torch.load(backbone_pth, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    lin = torch.load(lpips_pth, map_location="cpu")
    out = {"net": np.array(net)}
    if net == "alex":
        conv_ids = [0, 3, 6, 8, 10]
    elif net == "vgg":
        conv_ids = _VGG_CONV_IDS
    elif net == "squeeze":
        conv_ids = [0]
        for i, fid in enumerate(_SQUEEZE_FIRE_IDS):
            for part in ("squeeze", "expand1x1", "expand3x3"):
                out[f"fire{i}/{part}/w"] = \
                    sd[f"features.{fid}.{part}.weight"].numpy()
                out[f"fire{i}/{part}/b"] = \
                    sd[f"features.{fid}.{part}.bias"].numpy()
    else:
        raise ValueError(net)
    for i, cid in enumerate(conv_ids):
        out[f"conv{i}/w"] = sd[f"features.{cid}.weight"].numpy()
        out[f"conv{i}/b"] = sd[f"features.{cid}.bias"].numpy()
    for i in range(len(_CHNS[net])):
        key = f"lin{i}.model.1.weight"
        if key not in lin:
            key = f"lins.{i}.model.1.weight"
        out[f"lin{i}/w"] = lin[key].numpy()
    np.savez(out_npz, **out)
    return out_npz


class LPIPS:
    """The LPIPS network on `device`, from the weights file if it exists."""

    def __init__(self, weights_path=None, *, device):
        self.device = torch.device(device)
        self.weights = None
        self.net = "alex"
        path = weights_path or os.environ.get("VL3D_LPIPS_WEIGHTS", "")
        if path and os.path.exists(path):
            z = np.load(path)
            self.weights = {k: torch.as_tensor(z[k], device=self.device)
                            for k in z.files if k != "net"}
            if "net" in z.files:
                self.net = str(z["net"])

    @property
    def available(self):
        return self.weights is not None

    def _conv(self, h, name, stride=1, pad=0):
        return F.conv2d(h, self.weights[f"{name}/w"],
                        self.weights[f"{name}/b"], stride=stride,
                        padding=pad)

    def _features_alex(self, h):
        feats = []
        for i, (_, _, s, p) in enumerate(_ALEX_CFG):
            h = F.relu(self._conv(h, f"conv{i}", s, p))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def _features_vgg(self, h):
        feats = []
        ci = 0
        for si, stage in enumerate(_VGG_STAGES):
            if si > 0:
                h = F.max_pool2d(h, 2, 2)
            for _ in stage:
                h = F.relu(self._conv(h, f"conv{ci}", 1, 1))
                ci += 1
            feats.append(h)
        return feats

    def _features_squeeze(self, h):
        feats = []
        h = F.relu(self._conv(h, "conv0", 2, 0))
        feats.append(h)                                    # relu1
        for i in range(len(_SQUEEZE_FIRES)):
            if i in _SQUEEZE_POOL_BEFORE_FIRE:
                h = F.max_pool2d(h, 3, 2, ceil_mode=True)
            # fire module: squeeze 1x1 -> relu -> expand 1x1 & 3x3 (p1)
            sq = F.relu(self._conv(h, f"fire{i}/squeeze"))
            e1 = F.relu(self._conv(sq, f"fire{i}/expand1x1"))
            e3 = F.relu(self._conv(sq, f"fire{i}/expand3x3", 1, 1))
            h = torch.cat([e1, e3], 1)
            if i in _SQUEEZE_TAP_AFTER_FIRE:
                feats.append(h)
        return feats

    def features(self, x):
        """x: (B, 3, H, W) in [-1, 1] (numpy or tensor) -> the per-tap
        feature maps, each normalized over its channels (eps outside the
        sqrt, ref lpips.py:12-14)."""
        if not self.available:
            raise RuntimeError(
                "LPIPS weights unavailable; set VL3D_LPIPS_WEIGHTS or use "
                "convert_torch_weights()")
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        shift = torch.as_tensor(_SHIFT, device=self.device)[None, :, None,
                                                            None]
        scale = torch.as_tensor(_SCALE, device=self.device)[None, :, None,
                                                            None]
        with torch.inference_mode(), full_f32():
            h = (x - shift) / scale
            taps = {"alex": self._features_alex, "vgg": self._features_vgg,
                    "squeeze": self._features_squeeze}[self.net](h)
            return [t / (torch.sqrt(torch.sum(t * t, 1, keepdim=True))
                         + 1e-10) for t in taps]

    def distance(self, fa, fb):
        """(B,) distances between normalized features fa and fb (per tap
        (B, C, h, w), broadcast over B)."""
        with torch.inference_mode():
            total = 0.0
            for i, (na, nb) in enumerate(zip(fa, fb)):
                w = self.weights[f"lin{i}/w"]              # (1, C, 1, 1)
                proj = torch.sum((na - nb) ** 2 * w, dim=1, keepdim=True)
                total = total + torch.mean(proj, dim=(2, 3))
            return total[:, 0]

    def __call__(self, a, b):
        """a, b: (B, 3, H, W) in [-1, 1].  Returns (B,) distances."""
        return self.distance(self.features(a),
                             self.features(b)).cpu().numpy()


def _frames(video):
    """(F, H, W, 3) in [0, 255] -> (F, 3, H, W) in [-1, 1]."""
    return np.moveaxis(np.asarray(video, np.float32), -1, 1) / 127.5 - 1


def compute_lpips(net: LPIPS, pred, gt):
    """Min-over-gt-frames LPIPS per predicted frame, averaged (ref
    evaluations/LPIPS.py:18-30).  pred/gt: (F, H, W, 3) in [0, 255].  Each
    frame's features are computed once; a pair's distance depends only on
    its two frames' features."""
    fp = [net.features(f[None]) for f in _frames(pred)]
    fg = net.features(_frames(gt))
    scores = [float(net.distance(f, fg).min()) for f in fp]
    return float(np.mean(scores))


def compute_lpips_slidewindow(net: LPIPS, pred, gt):
    """Best time-aligned window LPIPS (ref evaluations/LPIPS.py:33-51)."""
    if len(pred) > len(gt):
        pred, gt = gt, pred
    fp = net.features(_frames(pred))
    fg = net.features(_frames(gt))
    n = len(gt) - len(pred)
    if n <= 0:
        return float(np.mean(net.distance(fp, fg).cpu().numpy()))
    errs = [np.mean(net.distance(fp, [t[i:i + len(pred)] for t in fg])
                    .cpu().numpy()) for i in range(n)]
    return float(np.min(errs))
