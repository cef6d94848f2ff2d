"""Kernel names to kernel numbers and layers, unknown port kernels, the
K9/K10 split of the binned pipeline, Adam's ranges, busy time and gaps,
on a hand-made trace."""
import os
from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench import trace as T

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PKG = os.path.join(ROOT, "videoloop3d_torch")


def ev(name, t0, t1, dev=DeviceType.CUDA, ann=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=t0, end=t1), device_type=dev, is_user_annotation=ann)


class Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def test_base_names():
    cases = {
        "(anonymous namespace)::bin_hist_kernel(unsigned int const*, int)":
            "bin_hist_kernel",
        "(anonymous namespace)::fused_s2_bwd_tile_kernel((anonymous "
        "namespace)::In, float const*)": "fused_s2_bwd_tile_kernel",
        "void (anonymous namespace)::tiles_zero_kernel<4>(int const*)":
            "tiles_zero_kernel",
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<at::native::(anonymous namespace)::TensorListMetadata<4>>(int)":
            "multi_tensor_apply_kernel",
        "warp_lookup_kernel(float const*, int)": "warp_lookup_kernel",
        "Memcpy HtoD (Pageable -> Device)": "Memcpy HtoD",
    }
    for name, base in cases.items():
        assert T.base_name(name) == base


def test_table_covers_every_port_kernel():
    assert T.port_kernel_names(PKG) == set(T.load_table())


def test_trace_reduction(tmp_path, capsys):
    # a fake package whose sources hold one kernel the table lacks
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "x.cu").write_text("__global__ void new_thing_kernel(int a) {}\n"
                               "__global__ void __launch_bounds__(64)\n"
                               "tiles_key_kernel(int k) {}\n")
    events = [
        ev("portbench.step", 0, 100, DeviceType.CPU),
        ev("aten::item", 40, 60, DeviceType.CPU),
        ev("warp_lookup_kernel(float const*)", 0, 10),
        ev("(anonymous namespace)::tiles_key_kernel(int const*)", 10, 12),
        ev("(anonymous namespace)::bin_hist_kernel(unsigned)", 12, 13),
        ev("void (anonymous namespace)::tiles_zero_rows_kernel<4>(int)",
           13, 14),
        ev("void (anonymous namespace)::tiles_grad_gather_kernel<4>(f)",
           14, 20),
        ev("(anonymous namespace)::tiles_key_kernel(int const*)", 20, 21),
        ev("void (anonymous namespace)::tiles_zero_kernel<4>(int)", 21, 22),
        ev("void (anonymous namespace)::tiles_grad_gather_kernel<4>(f)",
           22, 30),
        ev("new_thing_kernel(int)", 30, 40),
        ev("void at::native::elementwise_kernel<128>(int)", 60, 70),
        ev("Optimizer.step#Adam.step", 70, 90, ann=True),
        ev("void at::native::multi_tensor_apply_kernel<X>(int)", 70, 90),
    ]
    tr = T.Trace(Prof(events), window_s=100e-6, n_steps=1,
                 package_dir=str(tmp_path))
    ks = [op["k"] for op in tr.ops]
    assert ks == ["K1", "K9", "K9", "K9", "K9", "K10", "K10", "K10",
                  "unmapped", None, None]
    assert "new_thing_kernel" in capsys.readouterr().err
    assert [op["adam"] for op in tr.ops][-1] is True
    assert tr.busy_s == 70e-6                   # 0-40, 60-70, 70-90
    assert tr.gaps == [(40, 60)]
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["aten::item", 20e-6]]
    assert bd["device_ops"][0] == ["multi_tensor_apply_kernel", 20e-6]
    assert tr.per_step_ms(lambda op: op["adam"]) == 0.02
