"""The port's EDSR and MoE-EDSR nets against the flax ones, weight for
weight: the same numpy-seeded inputs, the flax variables carried by
``load_jax_params``. JAX runs as its own tests run it on the CPU: the Pallas
rank kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import init, randomize
from vsr_tpu.models import EDSRNet as JaxEDSRNet
from vsr_tpu.models import MoEEDSRNet as JaxMoEEDSRNet
from vsr_tpu.models import edsr as jedsr
from vsr_tpu.models import moe as jmoe
from vsr_tpu.ops.rank import pairwise_rank as jax_pairwise_rank
from vsr_tpu_torch.interop import load_jax_params
from vsr_tpu_torch.models import DUFNet, EDSRNet, MoEEDSRNet
from vsr_tpu_torch.models import edsr, moe

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _first(x, ndim_spatial=2):
    """Channels-last numpy -> channel-first torch."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, -ndim_spatial - 1)))


def _last(t, ndim_spatial=2):
    return np.moveaxis(t.detach().numpy(), -ndim_spatial - 1, -1)


def _init(module, *xs, seed=0, **kw):
    """The module's variables drawn with numpy over its traced shapes
    (``tests/_torch_parity.init``: no flax init compiled; biases and other
    constant leaves randomized), the MoE router and expert weights
    LeCun-normal over their fan-in, as flax draws them, and the PReLU alphas
    at flax's 0.2."""
    draw = np.random.default_rng(seed + 1000)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("router", "expert_wi", "expert_wo"):
            fan_in = leaf.shape[-2]
            return (draw.standard_normal(leaf.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name == "alpha":
            return np.full(leaf.shape, 0.2, np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(
        fill, randomize(init(module, *xs, seed=seed, **kw), draw))


def _randomize(variables, rng):
    """Non-trivial BatchNorm state and biases: random running mean / var,
    scale and bias (the init values 0 / 1 would hide a swapped leaf), and
    non-zero values for every zero-initialised leaf."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "expert_bi", "expert_bo"):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


# ------------------------------------------------------------------ blocks


def test_resblock(rng):
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    jblock = jedsr._ResBlock(6, 0.1)
    variables = _init(jblock, x)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = edsr._ResBlock(6, 0.1)
    load_jax_params(block, variables)
    with torch.no_grad():
        got = _last(block(_first(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_upblock_returns_the_pre_shuffle_array(rng, factor):
    x = rng.standard_normal((1, 5, 6, 4)).astype(np.float32)
    jblock = jedsr._UpBlock(4, factor)
    variables = _init(jblock, x)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = edsr._UpBlock(4, factor)
    load_jax_params(block, variables)
    with torch.no_grad():
        got = _last(block(_first(x)))
    assert edsr._UpBlock.split(factor) == jedsr._UpBlock.split(factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_upblock_refuses_other_factors():
    with pytest.raises(NotImplementedError, match="upscale_factor=5"):
        edsr._UpBlock(4, 5)


# ------------------------------------------------------------- MoE routing

MOE_KW = dict(num_experts=4, capacity_factor=1.25, hidden_mult=2,
              group_size=128)


def _jax_affinities(x, router, gs):
    """The routing block of the flax layer: f32 contraction and softmax,
    zero padding to whole groups, the (G, e, gs) layout."""
    n, h, w, d = x.shape
    t, e = h * w, router.shape[1]
    logits = jnp.einsum("ntd,de->nte", jnp.asarray(x).reshape(n, t, d),
                        jnp.asarray(router))
    aff = jax.nn.softmax(logits, axis=-1)
    pad = (-t) % gs
    if pad:
        aff = jnp.concatenate([aff, jnp.zeros((n, pad, e), aff.dtype)], axis=1)
    return jnp.swapaxes(aff.reshape(n * (t + pad) // gs, gs, e), 1, 2)


def _jax_rank(af, impl):
    if impl == "rank_pallas":
        return np.asarray(jax_pairwise_rank(af, interpret=True))
    gs = af.shape[-1]
    a_i, a_j = af[..., :, None], af[..., None, :]
    j_lt_i = jnp.arange(gs)[None, :] < jnp.arange(gs)[:, None]
    return np.asarray(jnp.sum(
        ((a_j > a_i) | ((a_j == a_i) & j_lt_i)).astype(jnp.int32), axis=-1))


def _moe_pair(rng, router_impl, dispatch_impl, hw=(12, 12), d=8):
    """A flax layer and the port's, same weights, and an input whose token
    count (144) does not divide the group size (128): the padding branch."""
    x = rng.standard_normal((2, *hw, d)).astype(np.float32)
    kw = dict(MOE_KW, router_impl=router_impl, dispatch_impl=dispatch_impl)
    jlayer = jmoe.ExpertChoiceMoE(**kw)
    variables = _randomize(_init(jlayer, x), rng)
    layer = moe.ExpertChoiceMoE(d, **kw)
    load_jax_params(layer, variables)
    return x, jlayer, variables, layer


@pytest.mark.parametrize("router_impl", ["rank", "rank_pallas"])
def test_moe_selection_and_slots_are_bit_equal_given_the_same_affinities(
        rng, router_impl):
    x, _, variables, layer = _moe_pair(rng, router_impl, "sparse")
    af = _jax_affinities(x, variables["params"]["router"], 128)
    assert af.shape == (4, 4, 128)  # 2 images x 2 groups (144 -> 256 tokens)
    want = _jax_rank(af, router_impl)
    got = moe.route(torch.from_numpy(np.array(af)), router_impl)
    np.testing.assert_array_equal(got.numpy(), want)
    cap = layer.capacity(128)
    assert cap == 40
    # Selection mask and capacity slots (the one-hot of the rank).
    np.testing.assert_array_equal((got < cap).numpy(), want < cap)
    slots = (got[..., None] == torch.arange(cap)).float().numpy()
    np.testing.assert_array_equal(
        slots, np.asarray(jax.nn.one_hot(want, cap, dtype=jnp.float32)))
    assert slots.sum() == 4 * 4 * cap  # every expert fills its capacity


@pytest.mark.parametrize("router_impl", ["rank", "rank_pallas"])
@pytest.mark.parametrize("dispatch_impl", ["sparse", "dense"])
def test_expert_choice_moe(rng, router_impl, dispatch_impl):
    x, jlayer, variables, layer = _moe_pair(rng, router_impl, dispatch_impl)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _last(layer(_first(x)))
        af_t, gs = layer.affinities(_first(x))
    assert got.shape == want.shape and gs == 128

    # Routing is discrete: a one-ulp difference between the two frameworks'
    # router logits can flip a token at the capacity boundary. Compare the
    # selection masks first; tokens whose mask differs must lie within 1e-6
    # of the cap-th affinity, must be rare (at most 1 % of the real tokens),
    # and only they are left out of the output comparison.
    af_j = np.asarray(_jax_affinities(x, variables["params"]["router"], gs))
    np.testing.assert_allclose(af_t.numpy(), af_j, rtol=0, atol=1e-6)
    cap = layer.capacity(gs)
    sel_t = moe.route(af_t, "rank").numpy() < cap
    sel_j = _jax_rank(jnp.asarray(af_j), "rank") < cap
    flipped = sel_t != sel_j                                 # (G, e, gs)
    kth = np.sort(af_j, axis=-1)[..., -cap][..., None]
    assert np.all(np.abs(af_j - kth)[flipped] <= 1e-6)
    n, h, w, _ = x.shape
    token_flipped = flipped.any(axis=1).reshape(n, -1)[:, :h * w]
    assert token_flipped.mean() <= 0.01
    keep = ~token_flipped.reshape(n, h, w)
    np.testing.assert_allclose(got[keep], want[keep], **TOL)
    # The layer is a residual update that moves the selected tokens.
    assert np.abs(want - x).max() > 1e-2


def test_moe_dispatches_agree_and_cover_the_padding(rng):
    x, _, variables, sparse = _moe_pair(rng, "rank", "sparse", hw=(5, 7))
    dense = moe.ExpertChoiceMoE(8, **dict(MOE_KW, dispatch_impl="dense"))
    load_jax_params(dense, variables)
    with torch.no_grad():
        a, b = sparse(_first(x)), dense(_first(x))
    assert a.shape == (2, 8, 5, 7)  # 35 tokens: gs = 35, cap = 10
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_moe_params_join_the_activation_dtype(rng):
    x, _, _, layer = _moe_pair(rng, "rank", "sparse")
    with torch.no_grad():
        out = layer(_first(x).bfloat16())  # f32 leaves, bf16 activations
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("kw,exc,match", [
    (dict(router_impl="rnak"), ValueError, "Unknown router_impl"),
    (dict(dispatch_impl="sparce"), ValueError, "Unknown dispatch_impl"),
])
def test_moe_refuses_unported_and_unknown_impls(kw, exc, match):
    with pytest.raises(exc, match=match):
        moe.ExpertChoiceMoE(8, 4, **kw)


# -------------------------------------------------------------- whole nets


@pytest.mark.parametrize("factor,fused_tail", [(2, False), (2, True),
                                               (3, True), (4, False)])
def test_edsrnet(rng, factor, fused_tail):
    kw = dict(in_channels=1, out_channels=1, num_resblocks=3, num_features=8,
              upscale_factor=factor, fused_tail=fused_tail)
    x = rng.standard_normal((2, 10, 12, 1)).astype(np.float32)
    jnet = JaxEDSRNet(**kw)
    variables = _init(jnet, x, seed=2)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = EDSRNet(**kw)
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _last(net(_first(x)))
    assert got.shape == want.shape == (2, 10 * factor, 12 * factor, 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("router_impl", ["rank", "rank_pallas"])
@pytest.mark.parametrize("dispatch_impl", ["sparse", "dense"])
def test_moe_edsrnet(rng, router_impl, dispatch_impl):
    kw = dict(in_channels=1, out_channels=1, num_resblocks=4, num_features=8,
              upscale_factor=2, num_experts=4, group_size=128, moe_every=2,
              router_impl=router_impl, dispatch_impl=dispatch_impl,
              fused_tail=True)
    x = rng.standard_normal((2, 12, 12, 1)).astype(np.float32)
    jnet = JaxMoEEDSRNet(**kw)
    variables = _randomize(_init(jnet, x, seed=4), rng)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = MoEEDSRNet(**kw)
    assert len(net.moes) == 2
    load_jax_params(net, variables)
    with torch.no_grad():
        got = _last(net(_first(x)))
    assert got.shape == want.shape == (2, 24, 24, 1)
    # A token flipped at a capacity boundary (see test_expert_choice_moe)
    # would change a 3x3-conv neighbourhood of outputs: allow at most 1 % of
    # the output pixels off, none of them by much.
    off = ~np.isclose(got, want, **TOL)
    assert off.mean() <= 0.01, f"{off.mean():.4f} of the pixels disagree"
    assert np.abs(got - want).max() < 5e-2
    assert np.abs(want).max() > 1e-3


def test_seeded_init_of_the_new_nets_is_deterministic():
    def flat(net):
        return torch.cat([p.flatten() for p in net.parameters()])

    for make in (
            lambda s: MoEEDSRNet(1, 1, 2, 8, 2, num_experts=2,
                                 generator=torch.Generator().manual_seed(s)),
            lambda s: DUFNet(1, 1, 7, 3, 2,
                             generator=torch.Generator().manual_seed(s))):
        a, b, c = flat(make(0)), flat(make(0)), flat(make(1))
        assert torch.equal(a, b) and not torch.equal(a, c)
    moe_layer = moe.ExpertChoiceMoE(64, 4,
                                    generator=torch.Generator().manual_seed(0))
    # LeCun-normal over the per-expert fan-in, biases zero.
    assert abs(moe_layer.expert_wi.std().item() - 64 ** -0.5) < 0.01
    assert abs(moe_layer.expert_wo.std().item() - 128 ** -0.5) < 0.01
    assert not moe_layer.expert_bi.any() and not moe_layer.expert_bo.any()


@pytest.mark.parametrize("make,shape,out_dtype", [
    (lambda: EDSRNet(1, 1, 2, 8, 2, dtype="bfloat16"), (2, 1, 8, 8),
     torch.bfloat16),
    (lambda: MoEEDSRNet(1, 1, 2, 8, 2, num_experts=2, group_size=32,
                        router_impl="rank_pallas", dtype=torch.bfloat16),
     (2, 1, 8, 8), torch.bfloat16),
    # The filters meet the raw (float32) centre frame in their promotion,
    # so the output is float32, as in the JAX net.
    (lambda: DUFNet(1, 1, 7, 3, 2, dtype="bfloat16"), (2, 7, 1, 8, 8),
     torch.float32),
    # The fused filter op casts to float32 and returns float32, so the sum
    # with the bf16 residual promotes, as in the JAX net.
    (lambda: DUFNet(1, 1, 7, 3, 2, dtype="bfloat16", use_pallas_filter=True),
     (2, 7, 1, 8, 8), torch.float32),
])
def test_new_nets_serve_in_bf16(rng, make, shape, out_dtype):
    net = make().eval()
    # Every net follows the precision policy: float32 parameters, bf16
    # compute.
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        out = net(x)
    assert out.dtype == out_dtype and out.shape == (2, 1, 16, 16)
    assert torch.isfinite(out.float()).all()
