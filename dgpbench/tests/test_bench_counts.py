"""The frozen counters: multiply-adds of the published architectures, the
layer plans against the reference's own convolutions, and the bounds."""

import hashlib
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dgpbench import data
from dgpbench.counts import flops, roofline
from dgpbench.reference import arch, models

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name: str, **changes) -> dict:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(changes)
    return cfg


def test_resnet50_at_224_against_the_published_count():
    """He et al. (2016, Table 1) give ResNet-50 3.8e9 multiply-adds at
    224x224 (torchvision's v1.5 layout: 4.1e9). TF-slim's resnet_v1_50,
    which DeepLabCut runs, pools VALID (55x55, not 56x56) and strides on
    each block's last unit, so its first units of blocks 2-4 run at the
    lower resolution: 3.46e9, 9% under He et al."""
    cfg = config("resnet50_dlc_reaching", output_stride=32)
    macs = flops.macs_per_frame(cfg, (224, 224), head=False)
    assert macs == pytest.approx(3.8e9, rel=0.1)
    assert arch.map_hw(cfg, (224, 224)) == (14, 14)


def test_mobilenet_v2_at_224_against_the_published_count():
    """Sandler et al. (2018, Table 4): 300M multiply-adds at 224 with the
    1000-way classifier (1.28M of them)."""
    cfg = config("mobilenet_v2_1.0_dlc_reaching", output_stride=32)
    macs = flops.macs_per_frame(cfg, (224, 224), head=False) + 1280 * 1000
    assert macs == pytest.approx(300e6, rel=0.02)


@pytest.mark.parametrize("name", ["resnet50_dlc_reaching",
                                  "mobilenet_v2_1.0_dlc_reaching"])
@pytest.mark.parametrize("hw", [(64, 80), (65, 81)])
def test_counter_equals_the_reference_convolutions(name, hw):
    """The counter's plan against the convolutions the reference runs,
    counted from their actual shapes."""
    cfg = config(name)
    seen = []

    def counting_conv(x, weight, stride=1, padding=0, dilation=1, groups=1):
        y = models.plain_conv(x, weight, stride, padding, dilation, groups)
        _, cin_g, kh, kw = weight.shape
        seen.append(y.shape[1] * y.shape[2] * y.shape[3] * cin_g * kh * kw)
        return y

    def counting_transpose(x, weight, bias, stride):
        seen.append(x.shape[2] * x.shape[3] * weight.shape[0]
                    * weight.shape[1] * weight.shape[2] * weight.shape[3])
        return F.conv_transpose2d(x, weight, bias, stride)

    weights = data.make_weights(cfg, 0, "cpu")
    frames = torch.zeros((1, *hw, 3), dtype=torch.uint8)
    with torch.no_grad():
        out = models.forward(cfg, weights, frames, counting_conv,
                             counting_transpose)
    assert sum(seen) == flops.macs_per_frame(cfg, hw)
    assert tuple(out.shape[1:3]) == arch.map_hw(cfg, hw)


def test_cell_shapes():
    """Both configurations give (94, 104) maps at 747x832; ResNet-50 runs
    53 int8 convolutions (36 dense 1x1, 17 others), MobileNetV2 35."""
    r = config("resnet50_dlc_reaching")
    m = config("mobilenet_v2_1.0_dlc_reaching")
    assert arch.map_hw(r, (747, 832)) == arch.map_hw(m, (747, 832)) \
        == (94, 104)
    sites = flops.int8_sites(r, (747, 832))
    dense = [s for s in sites if s["k"] == 1 and s["stride"] == 1]
    assert (len(sites), len(dense)) == (53, 36)
    assert len(flops.int8_sites(m, (747, 832))) == 35


@pytest.mark.parametrize("name,n_specs,sha,macs,n_layers", [
    ("resnet50_dlc_reaching", 269, "23c2bcb993fda60c", 72_358_547_456, 54),
    ("mobilenet_v2_1.0_dlc_reaching", 264, "8a85cc33cd4e8c0e",
     6_817_118_464, 53)])
def test_the_two_families_are_pinned(name, n_specs, sha, macs, n_layers):
    """Each family's weights and layer plan at 747x832, fixed: the specs'
    names, shapes, roles and order (``make_weights`` draws one flat
    normal vector in spec order, so the order decides every weight), the
    multiply-adds with the head, the convolutions and the map size."""
    cfg = config(name)
    specs = models.param_specs(cfg)
    digest = hashlib.sha256(json.dumps(
        [[n, list(shape), role] for n, shape, role in specs]).encode())
    assert (len(specs), digest.hexdigest()[:16]) == (n_specs, sha)
    assert flops.macs_per_frame(cfg, (747, 832)) == macs
    assert len(arch.layers(cfg, (747, 832))) == n_layers
    assert arch.map_hw(cfg, (747, 832)) == (94, 104)


def test_bounds_and_busy_time():
    b = roofline.decode_bound((128, 94, 104, 5))
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0075, rel=0.05)
    mm = roofline.op_bound(2.0 * 4096 ** 3, 3 * 4096 ** 2, 1979e12)
    assert mm["bound_by"] == "operations"
    assert mm["bound_ms"] == pytest.approx(0.069, rel=0.02)
    assert roofline.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert roofline.kernel_class("void gemm_kernel<Foo>()") == "int8_gemm"
    assert roofline.kernel_class("softargmax_likelihood_kernel") == "decode"
    assert roofline.kernel_class("sm90_xmma_fprop_bf16") == "convolution"
    assert roofline.kernel_class(
        "void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
