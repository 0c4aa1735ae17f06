"""The port's U-FISH CNN spot predictor (merfish3d_tpu_torch.models.ufish
and its convolution K11, ops.conv2d) against the JAX package, on CPU.

K11's plain version (what the port runs on a CPU tensor, and what the
card's kernel is held to) is compared with the Pallas kernel it replaces
in interpret mode, as tests/test_conv2d.py runs it; the port's U-Net with
the reference's ``_FastUNet`` (the same folded formulation) and its Flax
apply; the predictor and the ONNX loader with the reference's, on the
repo's trained c8 checkpoint and on seeded c32 weights. The registration
stage with the CNN and its F1 pins: test_torch_cnn_uniform.py and
test_torch_cnn_decon.py.

Tolerances. f32: 2e-5 x max|ref| (tests/test_conv2d.py), the sums run in
another order. bf16: the operands are the same bf16 values and every sum
is f32, so an output may sit one bf16 rounding step away where the two f32
sums straddle a rounding boundary, plus 2**-20 x max|ref| for an output
near zero, whose f32 sums may differ in sign or by their own rounding.
"""

import pickle
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merfish3d_tpu.models import ufish as jufish
from merfish3d_tpu.models import ufish_onnx as jonnx
from merfish3d_tpu.ops.conv2d import conv2d_lanepack, supported
from merfish3d_tpu_torch.models import onnx_reader as tonnx_reader
from merfish3d_tpu_torch.models import ufish as tufish
from merfish3d_tpu_torch.models import ufish_onnx as tonnx
from merfish3d_tpu_torch.ops.conv2d import conv2d_same, conv2d_same_plain, same_pads

CKPT = Path(__file__).parent / "data" / "ufish_synthetic_c8.pkl"


def _variables():
    with open(CKPT, "rb") as fh:
        return pickle.load(fh)


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """One bf16 rounding step (unit in the last place) at |a|."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = _bf16_step(np.maximum(np.abs(got), np.abs(want))) + 2.0**-20 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------ (a) K11, plain
_CONV_CASES = [
    ((2, 32, 64, 32), (3, 3, 32, 32), "relu"),  # tests/test_conv2d.py: the c32 layer
    ((1, 16, 32, 64), (3, 3, 64, 64), "none"),
    ((1, 16, 16, 128), (3, 3, 128, 64), "relu"),
    ((1, 16, 32, 64), (2, 2, 64, 32), "none"),  # the resize decoder's 2x2 conv
    ((1, 16, 32, 32), (3, 3, 32, 64), "relu"),
    ((1, 16, 32, 64), (1, 1, 64, 128), "sigmoid"),
    ((2, 16, 64, 8), (3, 3, 8, 8), "relu"),  # the c8 widths
    ((1, 16, 32, 16), (3, 3, 16, 16), "relu"),
    ((1, 16, 64, 16), (2, 2, 16, 8), "none"),  # c8's 2x2 decoder conv
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kshape,act", _CONV_CASES)
def test_plain_conv_matches_pallas(shape, kshape, act, dtype):
    """K11's plain version against the Pallas lane-packed kernel in
    interpret mode, on the same operands rounded to ``dtype``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(kshape) * 0.2).astype(np.float32)
    b = rng.standard_normal(kshape[-1]).astype(np.float32)
    assert supported(shape, kshape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(conv2d_lanepack(jnp.asarray(x, jdt), w, b, act=act)).astype(np.float32)
    got = conv2d_same(_t(x, tdt), _t(w), _t(b), act=act)
    assert got.dtype == tdt and got.shape == shape[:3] + kshape[-1:]
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    else:
        assert_within_one_bf16_step(got, want)


@pytest.mark.parametrize(
    "shape,kshape,act",
    [((2, 16, 24, 1), (3, 3, 1, 8), "relu"),  # the first conv: Cin = 1
     ((2, 16, 24, 8), (1, 1, 8, 1), "sigmoid")],  # the head: 1x1, Co = 1
)
def test_plain_conv_matches_lax_on_narrow_convs(shape, kshape, act):
    """The convolutions the TPU kernel's gate refuses run in the reference
    through lax.conv with bf16 operands and f32 sums (``_FastUNet._conv``);
    the port runs them through K11 like every other."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(kshape) * 0.3).astype(np.float32)
    b = rng.standard_normal(kshape[-1]).astype(np.float32)
    assert not supported(shape, kshape)
    xb = jnp.asarray(x, jnp.bfloat16)
    y = jax.lax.conv_general_dilated(
        xb, jnp.asarray(w, jnp.bfloat16), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32,
    ) + jnp.asarray(b)
    y = jnp.maximum(y, 0.0) if act == "relu" else jax.nn.sigmoid(y)
    want = np.asarray(y.astype(jnp.bfloat16)).astype(np.float32)
    got = conv2d_same(_t(x, torch.bfloat16), _t(w), _t(b), act=act).float().numpy()
    assert_within_one_bf16_step(got, want)


def test_same_padding_and_out_dtype():
    """Flax SAME: lo = (k - 1) // 2 before, the rest after, so a 2x2
    kernel reads the next row and column. A bf16 conv can write f32."""
    assert [same_pads(k) for k in (1, 2, 3)] == [(0, 0), (0, 1), (1, 1)]
    x = torch.zeros((1, 4, 4, 1))
    x[0, 2, 3, 0] = 1.0
    w = torch.zeros((2, 2, 1, 1))
    w[1, 1, 0, 0] = 1.0  # picks x[i + 1, j + 1]
    y = conv2d_same_plain(x, w, torch.zeros(1))[0, :, :, 0]
    assert y[1, 2] == 1.0 and y.sum() == 1.0
    out = conv2d_same(x.bfloat16(), w, torch.zeros(1), out_dtype=torch.float32)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="act"):
        conv2d_same(x, w, torch.zeros(1), act="gelu")


# -------------------------------------------------- (b) the network
def _fast_unet_pair(up_mode):
    if up_mode == "resize":
        variables = _variables()
    else:
        net = jufish.UFishNet(base_features=8, up_mode="convtranspose")
        variables = jax.tree_util.tree_map(
            np.asarray, net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1), jnp.float32))
        )
    topo = tufish.topology_from_flax(variables)
    assert topo == {"base_features": 8, "depths": (1, 2, 4), "up_mode": up_mode}
    jnet = jufish.UFishNet(**topo)
    return variables, jnet, jufish._FastUNet(variables, jnet), tufish.UFishNet.from_flax(variables)


@pytest.mark.parametrize("up_mode", ["resize", "convtranspose"])
def test_unet_matches_fast_unet(up_mode):
    """The port's U-Net (weights through ``params_from_flax``) against the
    reference's ``_FastUNet`` in interpret mode on two 64x64 planes: in
    f32 within 5e-5 (tests/test_conv2d.py), and against the Flax apply too;
    in bf16 within two bf16 steps of the [0.5, 1) range (2**-7), since one
    layer's one-step differences travel through the later layers, with at
    most 1 % of the outputs differing at all. resize: the trained c8
    checkpoint (BatchNorm with statistics); convtranspose: a c8 init."""
    variables, jnet, fast, net = _fast_unet_pair(up_mode)
    x = np.random.default_rng(1).random((2, 64, 64, 1)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want32 = np.asarray(fast(jnp.asarray(x)))
        want16 = np.asarray(fast(jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    flax32 = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got32 = net(_t(x)).numpy()
        got16 = net(_t(x, torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().numpy()
    np.testing.assert_allclose(got32, want32, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got32, flax32, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got16, want16, rtol=0, atol=2.0**-7)
    assert np.mean(got16 != want16) <= 0.01
    assert 0.0 <= got32.min() and got32.max() <= 1.0


def test_params_from_flax_folds_batchnorm():
    """BatchNorm folds as the reference's ``_fold_bn`` (eps 1e-5), with the
    no-statistics branch (BN = its affine map); the ConvTranspose becomes
    a 1x1 conv with the flipped kernel and the tiled bias."""
    variables = _variables()
    state = tufish.params_from_flax(variables)
    p, s = variables["params"]["ConvBlock_1"], variables["batch_stats"]["ConvBlock_1"]
    k, b = jufish._fold_bn(p["Conv_0"]["kernel"], p["Conv_0"]["bias"], p["BatchNorm_0"], s["BatchNorm_0"])
    np.testing.assert_array_equal(state["blocks.1.0.weight"].numpy(), k)
    np.testing.assert_array_equal(state["blocks.1.0.bias"].numpy(), b)
    no_stats = {"params": variables["params"]}
    bn = p["BatchNorm_0"]
    k, b = jufish._fold_bn(p["Conv_0"]["kernel"], p["Conv_0"]["bias"], bn,
                           {"mean": np.zeros_like(bn["bias"]), "var": np.ones_like(bn["scale"])})
    np.testing.assert_array_equal(tufish.params_from_flax(no_stats)["blocks.1.0.weight"].numpy(), k)
    np.testing.assert_array_equal(tufish.params_from_flax(no_stats)["blocks.1.0.bias"].numpy(), b)
    variables, _, fast, _ = _fast_unet_pair("convtranspose")
    state = tufish.params_from_flax(variables)
    k, b = fast.ups[0]
    k1 = np.asarray(k)[::-1, ::-1].transpose(2, 0, 1, 3).reshape(1, 1, k.shape[2], -1)
    np.testing.assert_array_equal(state["ups.0.weight"].numpy(), k1)
    np.testing.assert_array_equal(state["ups.0.bias"].numpy(), np.tile(b, 4))
    np.testing.assert_array_equal(state["head.weight"].numpy(), fast.final[0])


# ------------------------------------------------ (c) the predictor
@pytest.fixture(scope="module")
def hermetic_bits():
    from merfish3d_tpu_torch.cli.simulation.convert_simulation_to_experiment import (
        generate_raw_experiment,
    )

    raw = generate_raw_experiment(shape=(12, 96, 96), n_spots=170, n_genes=20, n_blanks=4, seed=11,
                                  voxel_size_zyx_um=(0.315, 0.098, 0.098), distribution="uniform",
                                  axial_sigma_um=0.44)
    return raw.bits[0, :2].astype(np.float32)  # two bits, (2, 12, 96, 96)


def test_predictor_matches_reference(hermetic_bits):
    """Normalized planes equal the reference's up to f32 rounding (4 ulp of
    [0, 1]). Probabilities against the reference's default path, the Flax
    apply with every parameter in bf16: its BatchNorm runs after a bf16
    conv on bf16 statistics, where the port folds it in f32 and rounds the
    folded weights once, so the two differ by more than rounding steps —
    within 0.05 at any voxel and 2e-3 on average (the reference bounds its
    own bf16 path against f32 at 2e-2, tests/test_ufish_torch_parity.py)."""
    planes = hermetic_bits.reshape(-1, 96, 96)
    want = np.asarray(jax.vmap(jufish._percentile_normalize)(jnp.asarray(planes)))
    got = tufish.percentile_normalize(torch.as_tensor(planes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-24)
    variables = _variables()
    want = jufish.UFishPredictor(params=variables).predict_batch(hermetic_bits)
    pred = tufish.UFishPredictor(params=variables, device="cpu")
    got = pred.predict_batch(hermetic_bits)
    assert got.shape == hermetic_bits.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.05 and np.abs(got - want).mean() <= 2e-3
    # per plane: a batch of 5 (the last padded with zero planes) changes nothing
    np.testing.assert_array_equal(pred.predict_batch(hermetic_bits, batch_size=5), got)
    np.testing.assert_array_equal(pred.predict(hermetic_bits[1]), got[1])


def test_predictor_pads_reflect():
    """Planes pad to a multiple of pad_to by numpy's reflect (for pads past
    the plane's length too) and the network sees exactly those planes."""
    for n, total in ((5, 64), (96, 128), (2, 9), (1, 4)):
        idx = tufish._reflect_index(n, total, "cpu").numpy()
        np.testing.assert_array_equal(np.arange(n)[idx], np.pad(np.arange(n), (0, total - n), mode="reflect"))
    pred = tufish.UFishPredictor(base_features=4, device="cpu")
    out = pred.predict(np.random.default_rng(3).random((3, 40, 70)) * 100)
    assert out.shape == (3, 40, 70) and np.all((out >= 0) & (out <= 1))


# --------------------------------------------------- (d) checkpoints
def test_onnx_loader_matches_reference(tmp_path):
    """The port's and the reference's loaders give bit-equal variables from
    one file: a full-width c32 ConvTranspose checkpoint from numpy seed 0.
    The committed topology specs agree, and a wrong family fails loudly."""
    tensors = tonnx.seeded_onnx_initializers(0)
    path = tmp_path / "ufish_c32.onnx"
    path.write_bytes(tonnx_reader.encode_test_model(tensors))
    got, want = tonnx.load_ufish_onnx_params(path), jonnx.load_ufish_onnx_params(path)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves] and len(got_leaves) == 66
    for (_, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, b)
    assert tufish.topology_from_flax(got) == {"base_features": 32, "depths": (1, 2, 4),
                                             "up_mode": "convtranspose"}
    assert tonnx.load_topology_specs() == {**jonnx.load_topology_specs(),
                                           "_comment": tonnx.load_topology_specs()["_comment"]}
    assert tonnx.topology_spec() == jonnx.topology_spec()
    assert [list(t.shape) for t in tensors.values() if t.ndim == 4] == [
        op["weight_shape"] for op in tonnx.load_topology_specs()["families"]["ufish_c32"]["ops"]
        if "weight_shape" in op]
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(tonnx_reader.encode_test_model({"w": np.zeros((7, 3, 5, 5), np.float32)}))
    with pytest.raises(ValueError, match="stem"):
        tufish.get_predictor(checkpoint_path=bad, device="cpu")


def test_pickle_holding_other_objects_is_refused(tmp_path):
    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps({"params": {"w": [1.0, 2.0]}}))
    with pytest.raises(TypeError, match="params/w is a list"):
        tufish.get_predictor(checkpoint_path=path, device="cpu")
    path.write_bytes(pickle.dumps({"params": {"w": Path("x")}}))
    with pytest.raises(pickle.UnpicklingError, match="pathlib"):
        tufish.get_predictor(checkpoint_path=path, device="cpu")


def test_every_alias_resolves(tmp_path, monkeypatch):
    """Every alias resolves through ``$MERFISH3D_UFISH_MODEL_DIR`` as in the
    reference and loads as a CNN; an alias with no file falls back to the
    DoG predictor loudly, and "dog" asks for it quietly."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("MERFISH3D_UFISH_MODEL_DIR", str(tmp_path / "models"))
    with pytest.warns(UserWarning, match="NOT come from a CNN"):
        pred = tufish.get_predictor("simfish", device="cpu")
    assert pred.kind == "dog" and pred.model_name == "dog-fallback"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tufish.get_predictor("dog").kind == "dog"
    assert tufish.UFISH_MODEL_ALIASES == jufish.UFISH_MODEL_ALIASES
    assert tufish.DEFAULT_UFISH_MODEL == jufish.DEFAULT_UFISH_MODEL
    for seed, rel in enumerate(sorted(set(tufish.UFISH_MODEL_ALIASES.values()))):
        path = tmp_path / "models" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(tonnx_reader.encode_test_model(tonnx.seeded_onnx_initializers(seed, 4)))
    for alias, rel in tufish.UFISH_MODEL_ALIASES.items():
        assert tufish.resolve_checkpoint(alias) == jufish.resolve_checkpoint(alias) == tmp_path / "models" / rel
        pred = tufish.get_predictor(alias, device="cpu")
        assert pred.kind == "cnn" and pred.model_name == alias
        assert (pred.net.base_features, pred.net.depths, pred.net.up_mode) == (4, (1, 2, 4), "convtranspose")
    assert tufish.resolve_checkpoint("no-such-model") is None
