"""``neurst_tpu_torch/utils/param_bridge`` and the checkpoint reader.

The scan-stacked layout of ``neurst_tpu`` (``<stack>/layers/layer/..``
with a leading layer axis) is unstacked into the port's per-layer
model, legacy ``|V2`` bf16 checkpoints are read back exactly, unknown
and missing names raise, and ``chip_smoke.py``'s generated weights use
``neurst_tpu``'s own names and shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import neurst_tpu_torch  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeechTransformer  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.utils.checkpoints import \
    restore_checkpoint_params  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)
from neurst_tpu_torch.utils.param_policy import \
    cast_params_for_inference  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TRG_META = {"vocab_size": 20, "eos_id": 1, "bos_id": 2, "unk_id": 3}
SRC_META = {"audio_feature_dim": 12, "audio_feature_channels": 1}


def _toy_config(**overrides):
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    return dict(cfg, **{"model.params": dict(cfg["model.params"],
                                             **overrides)})


def _random_flat(jm, seed=0):
    rng = np.random.RandomState(seed)
    params = jm.init_params(jax.random.PRNGKey(0))
    return {k: (0.5 * rng.randn(*np.shape(v))).astype(np.float32)
            for k, v in flatten_params(params).items()}


def _port(cfg):
    return neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                        trg_meta=TRG_META, device="cpu")


def _inputs():
    rng = np.random.RandomState(1)
    return {"src": rng.randn(2, 21, 12, 1).astype(np.float32),
            "src_length": np.asarray([21, 13], np.int32),
            "trg_input": rng.randint(0, 20, (2, 4)).astype(np.int32)}


@pytest.fixture(scope="module")
def toy():
    cfg = _toy_config(dtype="float32")
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META)
    return cfg, jm, _random_flat(jm)


def test_scan_stacked_layout_is_unstacked():
    cfg = _toy_config(dtype="float32", **{"encoder.scan_layers": True,
                                          "decoder.scan_layers": True})
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META)
    flat = _random_flat(jm)
    assert any("/layers/layer/" in k for k in flat)
    tm = load_flat_params(_port(cfg), flat)
    inputs = _inputs()
    params = {}
    for name, value in flat.items():
        node = params
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    ref = np.asarray(jm.call(params, inputs))
    with torch.no_grad():
        ours = tm(inputs).numpy()
    assert np.abs(ours - ref).max() <= 1e-4


def test_void_bf16_checkpoint_is_rescued(toy, tmp_path):
    """bf16 arrays that np.savez stored as raw '|V2' bytes read back as
    the exact float32 values, and bridge into the model."""
    import ml_dtypes
    cfg, _, flat = toy
    bf16 = {k: v.astype(ml_dtypes.bfloat16) for k, v in flat.items()}
    path = tmp_path / "ckpt-1.npz"
    np.savez(path, **bf16)
    with np.load(path) as raw:
        assert raw[next(iter(bf16))].dtype.kind == "V"
    restored = restore_checkpoint_params(str(path))
    for name, value in bf16.items():
        assert restored[name].dtype == np.float32
        assert np.array_equal(restored[name], value.astype(np.float32))
    tm = load_flat_params(_port(cfg), restored)
    weights = tm.state_dict()["target_symbol_modality.weights"].numpy()
    assert np.array_equal(
        weights, bf16["target_symbol_modality/weights"].astype(np.float32))
    # ml_dtypes arrays bridge the same way as their raw bytes
    direct = flat_to_state_dict(bf16, _port(cfg))
    assert torch.equal(direct["target_symbol_modality.weights"],
                       torch.from_numpy(weights))


def test_unknown_name_raises(toy):
    cfg, _, flat = toy
    with pytest.raises(KeyError, match="does not have"):
        flat_to_state_dict(dict(flat, **{"encoder/extra/kernel":
                                         np.zeros((2, 2), np.float32)}),
                           _port(cfg))


def test_missing_name_raises(toy):
    cfg, _, flat = toy
    partial = {k: v for k, v in flat.items()
               if k != "decoder/layer_1/ffn/dense2/bias"}
    with pytest.raises(KeyError, match="not filled"):
        flat_to_state_dict(partial, _port(cfg))


def test_wrong_shape_raises(toy):
    cfg, _, flat = toy
    bad = dict(flat)
    bad["encoder/output_ln/scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        flat_to_state_dict(bad, _port(cfg))


@pytest.mark.parametrize("name", ["speech_transformer_toy",
                                  "speech_transformer_s"])
def test_chip_smoke_weights_use_neurst_tpu_layout(name):
    """chip_smoke.py writes its seeded weights under neurst_tpu's own
    names and flax shapes (checked against the JAX model's init shapes
    without allocating them)."""
    cfg = JaxSpeechTransformer.build_model_args_by_name(name)
    params = dict(cfg["model.params"], dtype="float32")
    meta = {"audio_feature_dim": 80, "audio_feature_channels": 1}
    trg = dict(TRG_META, vocab_size=64)
    jm = jax_build(dict(cfg, **{"model.params": params}), src_meta=meta,
                   trg_meta=trg)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    expected = {k: tuple(v.shape) for k, v in flatten_params(
        shapes).items()}
    ours = chip_smoke.speech_transformer_flat_params(cfg, 64, 80, seed=0)
    assert {k: v.shape for k, v in ours.items()} == expected


def test_bf16_at_rest_gives_identical_outputs(toy):
    """cast_params_for_inference: a bf16-compute model gives the same
    logits with bf16-stored weights; LayerNorm params stay float32.  The
    tied softmax bias is the one weight read in float32 (added to the
    float32 logits), so the bf16 storage rounds it, as in the JAX
    package's policy; the float32-at-rest run uses its rounded value."""
    cfg, _, flat = toy
    bf16_cfg = dict(cfg, **{"model.params": dict(cfg["model.params"],
                                                 dtype="bfloat16")})
    inputs = _inputs()
    tm = load_flat_params(_port(bf16_cfg), flat)
    with torch.no_grad():
        bias = tm.target_symbol_modality.bias
        bias.copy_(bias.bfloat16().float())
        f32_at_rest = tm(inputs)
        cast_params_for_inference(tm, "bfloat16")
        bf16_at_rest = tm(inputs)
    assert torch.equal(f32_at_rest, bf16_at_rest)
    assert tm.encoder.output_ln.scale.dtype == torch.float32
    assert tm.encoder.layer_0.ffn.dense1.weight.dtype == torch.bfloat16
    assert tm.target_symbol_modality.weights.dtype == torch.bfloat16
