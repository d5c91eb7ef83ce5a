"""The trunk's conv epilogue ``uwcv_tpu_torch/ops/frozen_bn.py`` on the CPU.

The op ``uwcv::frozen_bn_act`` runs the plain chain on the CPU: it must
equal, bit for bit, the FrozenBN + residual + ReLU chain that
``models/resnet.py`` wrote inline before the op existed (``_chain`` and
``_old_trunk`` below).  Where a gradient flows the wrapper keeps that
chain, so gradients are unchanged; where none does the ResNet takes the
op, one call a conv epilogue, and launches no kernel on the CPU.  The
kernel itself is held to the chain on the card in
``tests/test_torch_port_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from torch_port_harness import hang_report, hang_report_module  # noqa: F401
from uwcv_tpu_torch.models.resnet import ResNet
from uwcv_tpu_torch.ops.frozen_bn import (
    _check,
    frozen_bn_act,
    frozen_bn_act_reference,
)
from uwcv_tpu_torch.parallel import mesh, spatial
from uwcv_tpu_torch.utils import trace

RESIDUALS = ["none", "identity", "affine"]


def _bn(x, scale, bias):
    """``FrozenBN.forward`` as it was: two broadcast ops."""
    return x * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def _chain(x, s, b, r=None, rs=None, rb=None):
    y = _bn(x, s, b)
    if r is not None:
        y = y + (r if rs is None else _bn(r, rs, rb))
    return F.relu(y)


def _old_trunk(net, x):
    """``ResNet.forward`` as it was before the op, without a model axis."""
    x = F.relu(_bn(net.stem_conv(x), net.stem_bn.scale, net.stem_bn.bias))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = {}
    for stage, n_blocks in enumerate(net.blocks):
        for b in range(n_blocks):
            blk = getattr(net, f"res{stage + 2}_block{b}")
            shortcut = x
            if blk.use_projection:
                shortcut = _bn(blk.shortcut_conv(x), blk.shortcut_bn.scale,
                               blk.shortcut_bn.bias)
            y = F.relu(_bn(blk.conv1(x), blk.bn1.scale, blk.bn1.bias))
            y = F.relu(_bn(blk.conv2(y), blk.bn2.scale, blk.bn2.bias))
            y = _bn(blk.conv3(y), blk.bn3.scale, blk.bn3.bias)
            x = F.relu(y + shortcut)
        feats[f"c{stage + 2}"] = x
    return feats


def _inputs(dtype, residual, channels_last=True, shape=(2, 16, 5, 7),
            seed=0):
    """(x, scale, bias, residual, residual_scale, residual_bias)."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    t = lambda *s: (torch.randn(*s, generator=g) * 2).to(dtype)
    x = t(*shape).contiguous(memory_format=fmt)
    r = None if residual == "none" else t(*shape).contiguous(
        memory_format=fmt)
    rs, rb = (t(c), t(c)) if residual == "affine" else (None, None)
    return x, t(c), t(c), r, rs, rb


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _seeded_resnet(depth, dtype, seed=0):
    torch.manual_seed(seed)
    net = ResNet(depth)
    for mod in net.modules():
        if hasattr(mod, "scale") and isinstance(mod.scale, torch.Tensor):
            mod.scale.uniform_(0.5, 1.5)
            mod.bias.uniform_(-0.2, 0.2)
    return net.to(dtype)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (1, 24, 7, 3)])
@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_on_the_cpu_equals_the_chain_bit_for_bit(dtype, residual, shape,
                                                    channels_last):
    args = _inputs(dtype, residual, channels_last, shape)
    want = _chain(*args)
    with torch.no_grad(), trace.recording() as rec:
        got = frozen_bn_act(*args)
    assert rec.counters == {"frozen_bn.fused": 1}
    assert torch.equal(_bits(got), _bits(want))
    assert got.stride() == want.stride()
    assert torch.equal(_bits(frozen_bn_act_reference(*args)), _bits(want))


@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_op_gives_shape_dtype_and_memory_format(dtype, residual):
    args = _inputs(dtype, residual)
    real = torch.ops.uwcv.frozen_bn_act(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.uwcv.frozen_bn_act(
            *(None if a is None else mode.from_tensor(a) for a in args))
    assert fake.shape == real.shape and fake.dtype == real.dtype == dtype
    assert fake.stride() == real.stride()
    assert fake.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("residual", RESIDUALS)
def test_frozen_bn_op_passes_opcheck(residual):
    args = _inputs(torch.float32, residual, seed=3)
    torch.library.opcheck(torch.ops.uwcv.frozen_bn_act.default, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_without_a_gradient_takes_the_op(dtype):
    """ResNet-26 under no_grad: 13 op calls (the stem and 3 a block), no
    chain, no kernel launch on the CPU, every level bit-equal to the
    trunk written as before the op."""
    net = _seeded_resnet(26, dtype)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    before = frozen_bn_act.launches
    with torch.no_grad(), trace.recording() as rec:
        got = net(x)
        want = _old_trunk(net, x)
    assert rec.counters == {"frozen_bn.fused": 13}
    assert frozen_bn_act.launches == before == 0
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("frozen,fused", [((), 0), (("stem_", "res2_"), 4)])
def test_trunk_with_a_gradient_keeps_the_chain_and_its_gradients(frozen,
                                                                  fused):
    """Training: the epilogues a gradient flows through run the chain
    (``frozen_bn.plain``); those of frozen stages (no input requires grad)
    take the op.  Outputs and every weight's gradient are bit-equal to the
    trunk written as before the op."""
    net = _seeded_resnet(26, torch.float32)
    for name, p in net.named_parameters():
        p.requires_grad_(not name.startswith(frozen) if frozen else True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 64, 96, generator=g)
    weights = {k: torch.randn(v.shape, generator=g)
               for k, v in _old_trunk(net, x).items()}

    def grads(forward):
        net.zero_grad()
        feats = forward(x)
        sum((feats[k] * w).sum() for k, w in weights.items()).backward()
        return feats, {n: p.grad.clone() for n, p in net.named_parameters()
                       if p.requires_grad}

    with trace.recording() as rec:
        got, got_g = grads(net)
    want, want_g = grads(lambda t: _old_trunk(net, t))
    assert rec.counters == {"frozen_bn.plain": 13 - fused,
                            **({"frozen_bn.fused": fused} if fused else {})}
    assert frozen_bn_act.launches == 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got_g.keys() == want_g.keys() and got_g
    for n in want_g:
        assert torch.equal(got_g[n], want_g[n]), n


def test_model_axis_shards_take_the_op_part_by_part():
    """``Shards`` of a ``DeviceRow``: one op call a part, each part equal to
    the chain on that part's rows."""
    args = _inputs(torch.float32, "affine", shape=(2, 8, 130, 6))
    rows = mesh.height_shards(130, 2)
    split = lambda t: spatial.Shards([t[:, :, a:b].contiguous(
        memory_format=torch.channels_last) for a, b in rows])
    x, s, b, r, rs, rb = args
    with torch.no_grad(), trace.recording() as rec:
        got = frozen_bn_act(split(x), s, b, split(r), rs, rb)
    assert rec.counters == {"frozen_bn.fused": 2}
    assert isinstance(got, spatial.Shards) and len(got.parts) == 2
    for part, (a, z) in zip(got.parts, rows):
        want = _chain(x[:, :, a:z], s, b, r[:, :, a:z], rs, rb)
        assert torch.equal(part, want)


def test_kernel_input_check_raises_on_what_the_kernel_does_not_take():
    """``_check`` guards the kernel (it runs on the card's tensors before
    each launch): channels-last, C % 8 == 0, one dtype, [C] parameters,
    the residual's affine in pairs."""
    x, s, b, r, rs, rb = _inputs(torch.bfloat16, "affine")
    assert _check(x, s, b, None, None, None) == 0
    assert _check(x, s, b, r, None, None) == 1
    assert _check(x, s, b, r, rs, rb) == 2
    bad = [
        (x.contiguous(), s, b, None, None, None),
        (x[:, :12].contiguous(memory_format=torch.channels_last), s[:12],
         b[:12], None, None, None),
        (x, s.float(), b, None, None, None),
        (x, s[:8], b, None, None, None),
        (x, s, b, r.contiguous(), None, None),
        (x, s, b, r, rs, None),
        (x, s, b, None, rs, rb),
        (x.half(), s.half(), b.half(), None, None, None),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            _check(*case)


@pytest.mark.parametrize("n", [1, 2])
def test_row_shards_stay_channels_last_through_the_edge_pad(n):
    """The op takes only channels-last activations on a card.  Over row
    shards, a shard that takes no halo rows (the first, for the stem's
    max-pool and each stride-2 3×3 conv) comes back from the exchange as
    a view; at batch 1 its strides made ``F.pad`` return NCHW.  Every
    epilogue of ResNet-26 over four shards sees channels-last parts, and
    the levels equal the unsharded trunk's."""
    net = _seeded_resnet(26, torch.float32)
    img = torch.randn(n, 3, 512, 128, generator=torch.Generator(
        ).manual_seed(4)).contiguous(memory_format=torch.channels_last)
    rows = mesh.height_shards(512, 4)
    seen = []

    def spy(x, *args):
        seen.append(all(p.is_contiguous(memory_format=torch.channels_last)
                        for p in x.parts))
        return frozen_bn_act(x, *args)

    with torch.no_grad():
        want = net(img)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("uwcv_tpu_torch.models.resnet.frozen_bn_act", spy)
            got = net(spatial.Shards([img[:, :, a:b].contiguous(
                memory_format=torch.channels_last) for a, b in rows]),
                spatial.DeviceRow(["cpu"] * 4))
    assert len(seen) == 13 and all(seen)
    for k in want:
        torch.testing.assert_close(torch.cat(got[k].parts, 2), want[k],
                                   rtol=1e-5, atol=1e-5)
