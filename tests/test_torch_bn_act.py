"""The frozen-BN tail kernel (``csrc/bn_act.cu``) and where it engages.

On the CPU:

* which calls of ``models/resnet.py::bn_act`` take the kernel: inference
  (no ``train``, no autograd) on a CUDA bfloat16 or float32 tensor in
  channels_last memory whose channels fill whole 16-byte vectors; the CPU,
  float64, ``train``, autograd, contiguous (NCHW) memory, other channel
  counts and unaligned tensors take the plain chain (fake CUDA tensors
  stand for the card's);
* the counters ``dgp.bn.fused`` and ``dgp.bn.plain`` count only inference
  calls, and the benchmark's ``bn_fused_share.infer`` reads them;
* the modules' plain path is the chain they ran before the kernel came,
  bit for bit, in inference and in training, gradients and moving
  statistics included;
* the custom op's CPU and fake implementations (``torch.library.opcheck``)
  and the kernel's names, which the benchmark books as elementwise work.

On the card (marker ``cuda``): the kernel against the plain chain, bit for
bit, in bfloat16 and float32, at every site of ResNet-50 and MobileNetV2
at 747x832, on strided and projection shortcuts, pixel counts that leave
a tail, and NaN, infinite and signed-zero inputs; its refusal of what it
does not take (odd channel counts, NCHW memory, an unaligned start),
which a unit then runs through the plain chain; both nets'
``forward_heads`` with the kernel and with the plain chain; and the
autograd path, which never launches it.
"""

import copy
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from deepgraphpose_tpu_torch.core.config import PoseConfig
from deepgraphpose_tpu_torch.models import mobilenet, resnet
from deepgraphpose_tpu_torch.models.pose_model import init_model
from deepgraphpose_tpu_torch.ops.kernels import bn_act_kernel as kernel
from deepgraphpose_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "deepgraphpose_tpu_torch" / "csrc" / "bn_act.cu"
CL = torch.channels_last
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
        torch.float64: torch.int64}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def counters():
    """The counters' increase over the test."""
    before = profiling.counters()

    def read():
        now = profiling.counters()
        return {k: now.get(k, 0) - before.get(k, 0)
                for k in ("dgp.bn.fused", "dgp.bn.plain")}

    return read


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit: NaN to NaN, -0 to -0."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(BITS[a.dtype]), b.view(BITS[b.dtype])))


def randomize_bn(module: torch.nn.Module, seed: int = 0) -> None:
    """Moving stats and affine parameters away from the identity, so that
    every multiply and add rounds."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, resnet.FrozenBatchNorm):
                c = m.scale.numel()
                m.scale.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.5 * torch.randn(c, generator=g))
                m.mean.copy_(0.5 * torch.randn(c, generator=g))
                m.var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))


def bn_count(module: torch.nn.Module) -> int:
    return sum(isinstance(m, resnet.FrozenBatchNorm)
               for m in module.modules())


# -- the modules' forward before the kernel came, word for word -------------

def chain_bottleneck(m, x, train=False):
    if m.project:
        shortcut = m.shortcut_bn(m.shortcut_conv(x), train)
    elif m.stride != 1:
        shortcut = x[:, :, ::m.stride, ::m.stride]
    else:
        shortcut = x
    y = F.relu(m.bn1(m.conv1(x), train))
    y = F.relu(m.bn2(m.conv2(y), train))
    y = m.bn3(m.conv3(y), train)
    return F.relu(shortcut + y)


def chain_inverted(m, x, train=False):
    y = x
    if m.has_expand:
        y = mobilenet.relu6(m.expand_bn(m.expand(y), train))
    y = mobilenet.relu6(m.depthwise_bn(m.depthwise(y), train))
    y = m.project_bn(m.project(y), train)
    return x + y if m.residual else y


def chain_tail(bn, x, act="none", residual=None, residual_bn=None):
    """bn_act's arguments through the modules' plain math."""
    y = bn(x)
    if residual is not None:
        r = residual if residual_bn is None else residual_bn(residual)
        y = r + y
    return kernel.ACTIVATIONS[act](y)


# (module, its forward before the kernel); units at 9x11 input
UNITS = {
    "bottleneck_project": (lambda d: resnet.BottleneckV1(16, 32, 8, 1, 1,
                                                         dtype=d),
                           chain_bottleneck),
    "bottleneck_project_stride2": (
        lambda d: resnet.BottleneckV1(16, 32, 8, 2, 1, dtype=d),
        chain_bottleneck),
    "bottleneck_subsample": (lambda d: resnet.BottleneckV1(32, 32, 8, 2, 1,
                                                           dtype=d),
                             chain_bottleneck),
    "bottleneck_identity_atrous": (
        lambda d: resnet.BottleneckV1(32, 32, 8, 1, 2, dtype=d),
        chain_bottleneck),
    "inverted_residual": (lambda d: mobilenet.InvertedResidual(
        16, 6, 16, 1, 1, dtype=d), chain_inverted),
    "inverted_stride2": (lambda d: mobilenet.InvertedResidual(
        16, 6, 24, 2, 1, dtype=d), chain_inverted),
    "inverted_no_expand": (lambda d: mobilenet.InvertedResidual(
        16, 1, 16, 1, 1, dtype=d), chain_inverted),
    # 13 and 39 channels: no whole vector, so the plain chain everywhere
    "inverted_odd_channels": (lambda d: mobilenet.InvertedResidual(
        13, 3, 13, 1, 1, dtype=d), chain_inverted),
}
CIN = {"bottleneck_subsample": 32, "bottleneck_identity_atrous": 32,
       "inverted_odd_channels": 13}


def unit_input(name: str, dtype, device="cpu", seed=1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, CIN.get(name, 16), 9, 11, generator=g)
    return x.to(device=device, dtype=dtype).contiguous(memory_format=CL)


def make_unit(name: str, dtype, device="cpu"):
    torch.manual_seed(0)
    unit = UNITS[name][0](dtype)
    randomize_bn(unit)
    return unit.to(device=device, memory_format=CL)


# -- CPU: the plain path is the old chain, and what is counted -------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64], ids=str)
@pytest.mark.parametrize("name", sorted(UNITS))
def test_inference_on_the_cpu_is_the_chain(name, dtype, counters):
    unit = make_unit(name, dtype).eval()
    x = unit_input(name, dtype)
    with torch.no_grad():
        got = unit(x)
        assert counters()["dgp.bn.plain"] == bn_count(unit)
        want = UNITS[name][1](unit, x)
    assert same_bits(got, want)
    assert counters()["dgp.bn.fused"] == 0


@pytest.mark.parametrize("train", [False, True, resnet.BatchStats(windows=2)],
                         ids=["eval", "train", "windows"])
@pytest.mark.parametrize("name", sorted(UNITS))
def test_training_is_the_chain(name, train, counters):
    """Under autograd: outputs, gradients and moving stats of the chain,
    bit for bit, and nothing counted."""
    dtype = torch.float32
    new = make_unit(name, dtype).train(bool(train))
    old = copy.deepcopy(new)
    x = unit_input(name, dtype)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    outs = [new(xs[0], train), UNITS[name][1](old, xs[1], train)]
    g = torch.randn(outs[0].shape, generator=torch.Generator().manual_seed(2))
    for out, inp in zip(outs, xs):
        out.backward(g)
    assert same_bits(outs[0], outs[1])
    assert same_bits(xs[0].grad, xs[1].grad)
    for (k, a), (_, b) in zip(new.named_parameters(), old.named_parameters()):
        assert same_bits(a.grad, b.grad), k
    for (k, a), (_, b) in zip(new.named_buffers(), old.named_buffers()):
        assert same_bits(a, b), k
    assert counters() == {"dgp.bn.fused": 0, "dgp.bn.plain": 0}


def test_training_under_no_grad_is_not_counted(counters):
    unit = make_unit("bottleneck_project", torch.float32)
    with torch.no_grad():
        unit(unit_input("bottleneck_project", torch.float32), True)
    assert counters() == {"dgp.bn.fused": 0, "dgp.bn.plain": 0}


# -- CPU: the predicate and the fused path's count, on fake CUDA tensors ----

def fake_cuda(shape, dtype=torch.bfloat16, strides=None):
    """A CUDA tensor of FakeTensorMode (no card needed): channels_last, or
    the given strides."""
    n, c, h, w = shape
    if strides is None:
        strides = (h * w * c, 1, w * c, c)
    return torch.empty_strided(shape, strides, dtype=dtype, device="cuda")


def unaligned_fake_cuda(shape, dtype=torch.bfloat16):
    """A channels_last fake CUDA tensor that starts one element into its
    storage."""
    n, c, h, w = shape
    store = torch.empty(n * c * h * w + 1, dtype=dtype, device="cuda")
    return store.as_strided(shape, (h * w * c, 1, w * c, c), 1)


SHAPE = (2, 16, 5, 7)


@pytest.mark.parametrize("case,fuses", [
    ("channels_last_bf16", True),
    ("channels_last_f32", True),
    ("contiguous_f32", False),
    ("c12_bf16", False),
    ("c12_f32", True),
    ("unaligned", False),
    ("residual", True),
    ("strided_residual", True),
    ("residual_nchw", False),
    ("residual_unaligned", False),
    ("float64", False),
    ("float16", False),
    ("not_dense", False),
    ("train", False),
    ("batch_stats", False),
    ("autograd", False),
    ("residual_other_dtype", False),
    ("residual_other_shape", False),
])
def test_which_calls_take_the_kernel(case, fuses):
    with FakeTensorMode():
        x = fake_cuda(SHAPE, torch.float32 if "f32" in case
                      else torch.bfloat16)
        if case == "contiguous_f32":
            x = fake_cuda(SHAPE, torch.float32, (560, 35, 7, 1))
        if case in ("float64", "float16"):
            x = fake_cuda(SHAPE, getattr(torch, case))
        if case == "not_dense":     # every other row of a taller tensor
            x = fake_cuda(SHAPE, strides=(16 * 10 * 7, 1, 2 * 7 * 16, 16))
        if case.startswith("c12"):  # 12 channels: 1.5 bf16 vectors, 3 f32
            x = fake_cuda((2, 12, 5, 7), x.dtype)
        if case == "unaligned":     # one element past a 16-byte boundary
            x = unaligned_fake_cuda(SHAPE)
        residual = {
            "residual": fake_cuda(SHAPE),
            "strided_residual": fake_cuda(SHAPE, strides=(
                16 * 10 * 14, 1, 2 * 14 * 16, 2 * 16)),
            "residual_nchw": fake_cuda(SHAPE, strides=(560, 35, 7, 1)),
            "residual_unaligned": unaligned_fake_cuda(SHAPE),
            "residual_other_dtype": fake_cuda(SHAPE, torch.float32),
            "residual_other_shape": fake_cuda((2, 16, 5, 1)),
        }.get(case)
        train = {"train": True,
                 "batch_stats": resnet.BatchStats()}.get(case, False)
        with torch.set_grad_enabled(case == "autograd"):
            assert resnet._fuses(x, train, residual) is fuses
    assert resnet._fuses(torch.empty(SHAPE).contiguous(memory_format=CL),
                         False, None) is False     # the CPU


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode"])
def test_fused_calls_count_their_batch_norms(projection, grad_mode,
                                             counters):
    """A fused tail counts each batch-norm it serves: two with a
    projection shortcut's. Its output is laid out as its input."""
    with FakeTensorMode():
        with torch.device("cuda"):
            bn, shortcut_bn = (resnet.FrozenBatchNorm(16) for _ in range(2))
        x, r = fake_cuda(SHAPE), fake_cuda(SHAPE)
        with getattr(torch, grad_mode)():
            y = resnet.bn_act(bn, x, False, "relu", r,
                              shortcut_bn if projection else None)
        assert y.device.type == "cuda" and y.stride() == x.stride()
    assert counters() == {"dgp.bn.fused": 1 + projection, "dgp.bn.plain": 0}


def read_share():
    from dgpbench import harness

    return harness.load_metric(REPO, "bn_fused_share.infer").read({})


def test_share_reads_the_counters():
    """``bn_fused_share.infer`` over a run: the CPU's plain calls and the
    card's fused ones."""
    profiling.reset()
    try:
        assert read_share() is None
        unit = make_unit("bottleneck_project", torch.float32).eval()
        with torch.no_grad():
            unit(unit_input("bottleneck_project", torch.float32))
        assert read_share() == 0.0
        with FakeTensorMode():
            with torch.device("cuda"):
                bn = resnet.FrozenBatchNorm(16)
            with torch.no_grad():
                for _ in range(3):
                    resnet.bn_act(bn, fake_cuda(SHAPE), False, "relu")
        assert read_share() == pytest.approx(100.0 * 3 / 7)
    finally:
        profiling.reset()


# -- CPU: the op, and the kernel's names ------------------------------------

def tail_inputs(dtype, residual=None, projection=False, seed=0,
                shape=SHAPE, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=CL)
    inv = (0.5 + torch.rand(c, generator=g)).to(dtype)
    shift = torch.randn(c, generator=g).to(dtype)
    r = inv_r = shift_r = None
    if residual == "dense":
        r = torch.randn(shape, generator=g).to(dtype).contiguous(
            memory_format=CL)
    elif residual == "subsample":   # slim's x[:, :, ::2, ::2]
        r = torch.randn(n, c, 2 * h, 2 * w, generator=g).to(dtype)
        r = r.contiguous(memory_format=CL)[:, :, ::2, ::2]
    if projection:
        inv_r = (0.5 + torch.rand(c, generator=g)).to(dtype)
        shift_r = torch.randn(c, generator=g).to(dtype)
    return [t if t is None else t.to(device)
            for t in (x, inv, shift, r, inv_r, shift_r)]


@pytest.mark.parametrize("act", kernel.ACTS)
@pytest.mark.parametrize("residual,projection", [
    (None, False), ("dense", False), ("dense", True), ("subsample", False)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_op_on_the_cpu_is_the_chain(dtype, residual, projection, act):
    """The op's CPU implementation: the plain chain, laid out as x."""
    args = tail_inputs(dtype, residual, projection)
    got = kernel.frozen_bn_act(*args, act=act)
    assert got.stride() == args[0].stride()
    assert same_bits(got, kernel.plain(*args, act=act))


@pytest.mark.parametrize("residual,projection", [
    (None, False), ("dense", True), ("subsample", False)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_op_schema_and_fake(dtype, residual, projection):
    args = tail_inputs(dtype, residual, projection)
    torch.library.opcheck(kernel.OP, (*args, "relu"))


@pytest.mark.parametrize("bad", ["act", "dtype", "not_dense", "factors",
                                 "residual_shape", "projection_alone"])
def test_op_refuses(bad):
    x, inv, shift, r, inv_r, shift_r = tail_inputs(torch.float32, "dense")
    act = "relu"
    if bad == "act":
        act = "gelu"
    elif bad == "dtype":
        x = x.double()
    elif bad == "not_dense":
        x = x[:, :, ::2]
    elif bad == "factors":
        inv = inv[:-1]
    elif bad == "residual_shape":
        r = r[:, :, 1:]
    elif bad == "projection_alone":
        r, inv_r, shift_r = None, inv, shift
    with pytest.raises(ValueError):
        kernel.frozen_bn_act(x, inv, shift, r, inv_r, shift_r, act)


def global_names() -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", SOURCE.read_text())


def test_kernel_names_are_booked_as_elementwise():
    """The benchmark books device time by kernel name
    (``dgpbench/counts/roofline.py::kernel_class``): each kernel, and its
    full name as the profiler shows it, is elementwise work, none of
    conv, copy, pad, cat or gemm."""
    from dgpbench.counts import roofline

    names = global_names()
    assert names == ["frozen_bn_act_nhwc_elementwise_kernel"]
    for name in names:
        full = (f"void (anonymous namespace)::{name}<(anonymous namespace)"
                f"::BF16, 2>((anonymous namespace)::TailArgs)")
        assert roofline.kernel_class(name) == "elementwise"
        assert roofline.kernel_class(full) == "elementwise"


# -- the card ---------------------------------------------------------------

def check_tail(args, act):
    before = kernel.launches
    got = kernel.frozen_bn_act(*args, act=act)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.stride() == args[0].stride()
    want = kernel.plain(*args, act=act)
    assert same_bits(got, want), (got.float() - want.float()).abs().max()


def with_specials(t: torch.Tensor, seed: int) -> torch.Tensor:
    """``t`` with NaN, +-inf and -0 at a few hundred seeded places."""
    g = torch.Generator().manual_seed(seed)
    flat = t.detach().cpu().reshape(-1).clone()
    idx = torch.randint(0, flat.numel(), (4, 64), generator=g)
    for row, value in zip(idx, (float("nan"), float("inf"), -float("inf"),
                                -0.0)):
        flat[row] = value
    return flat.reshape(t.shape).to(t.device).contiguous(
        memory_format=torch.channels_last if t.is_contiguous(
            memory_format=CL) else torch.contiguous_format)


@pytest.mark.cuda
@pytest.mark.parametrize("act", kernel.ACTS)
@pytest.mark.parametrize("residual,projection", [
    (None, False), ("dense", False), ("dense", True), ("subsample", False),
    ("subsample", True)])
@pytest.mark.parametrize("shape", [
    (2, 64, 23, 29),        # 8 bf16 vectors a pixel, 32 pixel rows a block
    (3, 24, 7, 5),          # 3 vectors a pixel; 105 rows leave a tail
    (2, 40, 9, 11),         # 5 bf16 vectors, 10 float32 ones
    (1, 2048, 3, 5)])       # C / 8 > 256: one pixel row a block
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_is_the_chain(cuda_device, dtype, shape, residual, projection,
                             act):
    args = tail_inputs(dtype, residual, projection, shape=shape,
                       device=cuda_device)
    check_tail(args, act)


def check_refused(args):
    """The kernel does not take ``args``: ``bn_act`` would run the plain
    chain, and the op on the card raises without a launch."""
    x, residual = args[0], args[3]
    assert not kernel.takes(x, residual)
    with torch.no_grad():
        assert not resnet._fuses(x, False, residual)
    before = kernel.launches
    with pytest.raises(ValueError, match="does not take"):
        kernel.frozen_bn_act(*args, act="relu")
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("residual,projection", [
    (None, False), ("dense", True), ("subsample", False)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_contiguous_memory(cuda_device, dtype, residual, projection):
    """NCHW-contiguous input (or residual): refused."""
    args = tail_inputs(dtype, residual, projection, shape=(2, 16, 7, 9),
                       device=cuda_device)
    if residual == "dense":
        args[3] = args[3].contiguous()
    else:
        args[0] = args[0].contiguous()
    check_refused(args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_refuses_odd_channels(cuda_device, dtype):
    """13 channels fill no whole vector; 12 fill three float32 vectors but
    no whole bfloat16 ones."""
    check_refused(tail_inputs(dtype, "dense", True, shape=(3, 13, 7, 5),
                              device=cuda_device))
    args = tail_inputs(dtype, "dense", False, shape=(2, 12, 9, 11),
                       device=cuda_device)
    if dtype == torch.float32:
        check_tail(args, "relu")
    else:
        check_refused(args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_odd_channels_on_the_card_are_the_chain(cuda_device, dtype,
                                                counters):
    """A unit whose channels fill no whole vector runs the plain chain in
    inference on the card: its bits, no launch, each batch-norm counted
    plain."""
    name = "inverted_odd_channels"
    unit = make_unit(name, dtype, cuda_device).eval()
    x = unit_input(name, dtype, cuda_device)
    before = kernel.launches
    with torch.no_grad():
        got = unit(x)
        assert counters() == {"dgp.bn.fused": 0,
                              "dgp.bn.plain": bn_count(unit)}
        want = UNITS[name][1](unit, x)
    assert kernel.launches == before
    assert same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("act", kernel.ACTS)
@pytest.mark.parametrize("shape", [(2, 64, 23, 29), (3, 24, 7, 5)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_special_values(cuda_device, dtype, shape, act):
    args = tail_inputs(dtype, "dense", True, shape=shape, device=cuda_device)
    args[0] = with_specials(args[0], 5)
    args[3] = with_specials(args[3], 6)
    check_tail(args, act)


@pytest.mark.cuda
def test_kernel_at_a_storage_offset(cuda_device):
    """Input 2 bytes past a 16-byte boundary: refused."""
    x, inv, shift, r, inv_r, shift_r = tail_inputs(
        torch.bfloat16, "dense", True, shape=(2, 64, 5, 7), device=cuda_device)
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xs = store[1:].view(2, 5, 7, 64).permute(0, 3, 1, 2)
    xs.copy_(x)
    assert xs.is_contiguous(memory_format=CL) and xs.data_ptr() % 16 == 2
    check_refused([xs, inv, shift, r, inv_r, shift_r])


def backbone(net: str, dtype, device):
    torch.manual_seed(0)
    make = (mobilenet.make_backbone if net.startswith("mobilenet")
            else resnet.make_backbone)
    model = make(net, dtype=dtype)
    randomize_bn(model)
    return model.to(device, memory_format=CL).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("net", ["resnet_50", "mobilenet_v2_1.0"])
def test_every_site_is_the_chain(cuda_device, monkeypatch, net, dtype,
                                 counters):
    """Each call of ``bn_act`` in a forward at 747x832, batch 2: one
    launch, bit for bit the plain chain on the same inputs."""
    model = backbone(net, dtype, cuda_device)
    sites = set()
    fused = resnet.bn_act

    def checked(bn, x, train=False, act="none", residual=None,
                residual_bn=None):
        before = kernel.launches
        got = fused(bn, x, train, act, residual, residual_bn)
        assert kernel.launches == before + 1
        want = chain_tail(bn, x, act, residual, residual_bn)
        assert same_bits(got, want), (tuple(x.shape), act)
        kind = (None if residual is None else "projection" if residual_bn
                else "identity" if residual.stride() == x.stride()
                else "subsample")
        sites.add((tuple(x.shape), act, kind))
        return got

    monkeypatch.setattr(resnet, "bn_act", checked)
    monkeypatch.setattr(mobilenet, "bn_act", checked)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 747, 832, generator=g).to(cuda_device, dtype)
    with torch.inference_mode():
        model(x.contiguous(memory_format=CL))
    # every batch-norm once through the kernel, and once through the
    # test's own chain (plain)
    n = bn_count(model)
    assert counters() == {"dgp.bn.fused": n, "dgp.bn.plain": n}
    kinds = {kind for _, _, kind in sites}
    if net == "resnet_50":
        assert kinds == {None, "identity", "subsample", "projection"}
    else:
        assert kinds == {None, "identity"}
    assert len(sites) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("net", ["resnet_50", "mobilenet_v2_1.0"])
def test_forward_heads_is_the_chain(cuda_device, net, dtype, counters):
    """``forward_heads`` with the kernel, and the same model under autograd
    (the plain chain), on deterministic cuDNN: the same bits."""
    from deepgraphpose_tpu_torch.infer.predict import (dlc_heads,
                                                       forward_heads,
                                                       inference_cudnn)

    cfg = PoseConfig(net_type=net, num_joints=5)
    model = init_model(cfg, torch.Generator().manual_seed(0), dtype=dtype,
                       device=cuda_device)
    randomize_bn(model)
    model.requires_grad_(False)
    images = torch.randint(0, 255, (2, 747, 832, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    images = images.to(cuda_device)
    heads = dlc_heads(model)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        before = kernel.launches
        got = forward_heads(model, images, heads=heads)
        assert kernel.launches > before
        assert counters()["dgp.bn.fused"] == bn_count(model)
        launched = kernel.launches
        with torch.enable_grad(), inference_cudnn():
            want = model(images, heads=heads)
        assert kernel.launches == launched
    assert counters()["dgp.bn.plain"] == 0
    for k in heads:
        assert same_bits(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(UNITS))
def test_autograd_on_the_card_is_the_chain(cuda_device, name, dtype,
                                           counters):
    """Under autograd the kernel never launches: outputs and gradients of
    the chain, bit for bit."""
    new = make_unit(name, dtype, cuda_device).eval()
    old = copy.deepcopy(new)
    x = unit_input(name, dtype, cuda_device)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    before = kernel.launches
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        outs = [new(xs[0]), UNITS[name][1](old, xs[1])]
        g = torch.randn(outs[0].shape, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device, dtype)
        for out in outs:
            out.backward(g)
    assert kernel.launches == before
    assert counters() == {"dgp.bn.fused": 0, "dgp.bn.plain": 0}
    assert same_bits(outs[0], outs[1])
    assert same_bits(xs[0].grad, xs[1].grad)
    for (k, a), (_, b) in zip(new.named_parameters(), old.named_parameters()):
        assert same_bits(a.grad, b.grad), k
