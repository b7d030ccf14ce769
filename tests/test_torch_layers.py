"""The port's layers against the flax modules of ``neurst_tpu``.

Each test builds the flax module and its port counterpart, draws one set
of parameters with numpy, carries it into the port through
``utils/param_bridge`` and feeds both the same numpy-seeded inputs, in
float32 (``jax_default_matmul_precision=float32`` from conftest; TF32
off in torch).  Tolerance 1e-5 throughout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from neurst_tpu.layers import common_layers as jcl  # noqa: E402
from neurst_tpu.layers import transformer_layers as jtl  # noqa: E402
from neurst_tpu.layers.attentions import \
    multi_head_attention as jmha  # noqa: E402
from neurst_tpu.layers.decoders.transformer_decoder import \
    TransformerDecoder as JDecoder  # noqa: E402
from neurst_tpu.layers.modalities import \
    audio_modalities as jaudio  # noqa: E402
from neurst_tpu_torch.layers import common_layers as tcl  # noqa: E402
from neurst_tpu_torch.layers import layer_utils  # noqa: E402
from neurst_tpu_torch.layers import transformer_layers as ttl  # noqa: E402
from neurst_tpu_torch.layers.attentions import \
    multi_head_attention as tmha  # noqa: E402
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder as TDecoder  # noqa: E402
from neurst_tpu_torch.layers.modalities import \
    audio_modalities as taudio  # noqa: E402
from neurst_tpu_torch.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    load_flat_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
D, N, FILTER = 16, 2, 24


def _init(module, rng, *args, method=None, **kwargs):
    """flax params of ``module`` redrawn with numpy (float32)."""
    variables = module.init(jax.random.PRNGKey(0), *args, method=method,
                            **kwargs)
    params = fnn.meta.unbox(variables["params"])
    return jax.tree_util.tree_map(
        lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), params)


def _port(tmodule, params):
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    return load_flat_params(tmodule, flat).eval()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    diff = np.abs(_np(a).astype(np.float32) - _np(b).astype(np.float32))
    assert diff.max() <= tol, diff.max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_layer_norm():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, D).astype(np.float32) * 2 + 1
    jm = jcl.LayerNorm()
    params = _init(jm, rng, x)
    _close(_port(tcl.LayerNorm(D), params)(_t(x)),
           jm.apply({"params": params}, x))


def test_transformer_ffn():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, D).astype(np.float32)
    jm = jcl.TransformerFFN(filter_size=FILTER, output_size=D)
    params = _init(jm, rng, x)
    _close(_port(tcl.TransformerFFN(D, FILTER, D), params)(_t(x)),
           jm.apply({"params": params}, x))


def _embedding_pair(rng, vocab=11):
    jm = jcl.WordEmbedding(vocab_size=vocab, embedding_dim=D,
                           share_softmax_weights=True, timing="sinusoids")
    params = _init(jm, rng, jnp.zeros((1, 2), jnp.int32))
    tm = _port(tcl.WordEmbedding(vocab, D, share_softmax_weights=True,
                                 timing="sinusoids"), params)
    return jm, tm, params


def test_word_embedding_sequence_and_attend():
    rng = np.random.RandomState(2)
    jm, tm, params = _embedding_pair(rng)
    ids = rng.randint(0, 11, (2, 6)).astype(np.int32)
    _close(tm(_t(ids).long()), jm.apply({"params": params}, ids))
    feats = rng.randn(2, 6, D).astype(np.float32)
    _close(tm.attend(_t(feats)),
           jm.apply({"params": params}, feats, method=jm.attend))


@pytest.mark.parametrize("time", [0, 3, 9])
def test_word_embedding_decode_time(time):
    rng = np.random.RandomState(3)
    jm, tm, params = _embedding_pair(rng)
    ids = rng.randint(0, 11, (4,)).astype(np.int32)
    _close(tm(_t(ids).long(), time=time),
           jm.apply({"params": params}, ids, time=time))


@pytest.mark.parametrize("channels", [8, 9])
def test_sinusoidal_position_signal(channels):
    _close(tcl.sinusoidal_position_signal(13, channels, start=5),
           jcl.sinusoidal_position_signal(13, channels, start=5))


def _cross_pair(rng, memory):
    jm = jmha.MultiHeadAttention(num_heads=N, num_units=D)
    params = _init(jm, rng, memory[:, :1], memory=memory)
    return jm, _port(tmha.MultiHeadAttention(N, D), params), params


def test_cross_attention_with_memory_bias():
    rng = np.random.RandomState(4)
    memory = rng.randn(2, 9, D).astype(np.float32)
    query = rng.randn(2, 4, D).astype(np.float32)
    jm, tm, params = _cross_pair(rng, memory)
    pad = np.zeros((2, 9), np.float32)
    pad[1, 5:] = 1.0
    jbias = jnp.asarray(pad * -1e9)[:, None, None, :]
    ours = tm(_t(query), memory=_t(memory),
              bias=layer_utils.input_padding_to_bias(_t(pad)))
    ref, _ = jm.apply({"params": params}, query, memory=memory, bias=jbias)
    _close(ours, ref)


def test_cross_attention_beam_shared_kv():
    """Query rows [B * beam] attend a cache of [B] memory k/v."""
    rng = np.random.RandomState(5)
    b, beam, t = 2, 3, 7
    memory = rng.randn(b, t, D).astype(np.float32)
    jm, tm, params = _cross_pair(rng, memory)
    query = rng.randn(b * beam, 1, D).astype(np.float32)
    pad = np.zeros((b, t), np.float32)
    pad[0, 4:] = 1.0
    k, v = jm.apply({"params": params}, memory, method=jm.compute_kv)
    ref, _ = jm.apply({"params": params}, query,
                      cache={"keys": k, "values": v},
                      bias=jnp.asarray(pad * -1e9)[:, None, None, :])
    tk, tv = tm.compute_kv(_t(memory))
    _close(tk, k)
    ours = tm(_t(query), cache={"keys": tk, "values": tv},
              bias=layer_utils.input_padding_to_bias(_t(pad)))
    _close(ours, ref)


def _self_pair(rng, x):
    jm = jmha.MultiHeadSelfAttention(num_heads=N, num_units=D)
    params = _init(jm, rng, x)
    return jm, _port(tmha.MultiHeadSelfAttention(N, D), params), params


def _step_bias(t, max_len):
    return np.where(np.arange(max_len) <= t, 0.0, -1e9).astype(
        np.float32)[None, None, None, :]


def test_self_attention_decode_writes_cache():
    rng = np.random.RandomState(6)
    b, max_len = 3, 6
    xs = rng.randn(max_len, b, 1, D).astype(np.float32)
    jm, tm, params = _self_pair(rng, xs[0])
    zeros = np.zeros((b, max_len, N, D // N), np.float32)
    jcache = {"keys": jnp.asarray(zeros), "values": jnp.asarray(zeros)}
    tcache = {"keys": _t(zeros.copy()), "values": _t(zeros.copy())}
    for t in range(4):
        bias = _step_bias(t, max_len)
        ref, jcache = jm.apply({"params": params}, xs[t], bias=bias,
                               cache=jcache, decode_step=t)
        with torch.no_grad():
            ours = tm(_t(xs[t]), bias=_t(bias), cache=tcache,
                      decode_step=t)
        _close(ours, ref)
    _close(tcache["keys"], jcache["keys"])
    _close(tcache["values"], jcache["values"])


def test_attend_indirect_with_scrambled_beam_anc():
    """Cache rows read through a random ancestor matrix: the gather
    selects the same dot products as the JAX one-hot."""
    rng = np.random.RandomState(7)
    b, beam, max_len, t = 2, 3, 8, 5
    x = rng.randn(b * beam, 1, D).astype(np.float32)
    jm, tm, params = _self_pair(rng, x)
    keys = rng.randn(b * beam, max_len, N, D // N).astype(np.float32)
    values = rng.randn(b * beam, max_len, N, D // N).astype(np.float32)
    anc = rng.randint(0, beam, (b, beam, max_len))
    bias = _step_bias(t, max_len)
    ref, _ = jm.apply({"params": params}, x, bias=bias,
                      cache={"keys": jnp.asarray(keys),
                             "values": jnp.asarray(values)},
                      decode_step=t, beam_anc=jnp.asarray(anc, jnp.int32))
    with torch.no_grad():
        ours = tm(_t(x), bias=_t(bias),
                  cache={"keys": _t(keys.copy()), "values": _t(values.copy())},
                  decode_step=t, beam_anc=_t(anc).long())
    _close(ours, ref)


def _layer_kwargs(post_normalize):
    return dict(hidden_size=D, num_attention_heads=N, filter_size=FILTER,
                post_normalize=post_normalize)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("post_normalize", [False, True])
def test_encoder_layer(post_normalize, flash):
    rng = np.random.RandomState(8)
    x = rng.randn(2, 10, D).astype(np.float32)
    lengths = np.asarray([10, 6], np.int32)
    pad = (np.arange(10)[None] >= lengths[:, None]).astype(np.float32)
    jm = jtl.TransformerEncoderLayer(**_layer_kwargs(post_normalize))
    params = _init(jm, rng, x, None)
    tm = _port(ttl.TransformerEncoderLayer(**_layer_kwargs(post_normalize)),
               params)
    if flash:
        ref = jm.apply({"params": params}, x, None,
                       flash_lengths=jnp.asarray(lengths))
        ours = tm(_t(x), None, flash_lengths=_t(lengths))
    else:
        ref = jm.apply({"params": params}, x,
                       jnp.asarray(pad * -1e9)[:, None, None, :])
        ours = tm(_t(x), layer_utils.input_padding_to_bias(_t(pad)))
    _close(ours, ref)


def _decoder_layer_pair(rng, post_normalize, x, memory):
    jm = jtl.TransformerDecoderLayer(**_layer_kwargs(post_normalize))
    params = _init(jm, rng, x, memory=memory)
    tm = _port(ttl.TransformerDecoderLayer(**_layer_kwargs(post_normalize)),
               params)
    return jm, tm, params


@pytest.mark.parametrize("post_normalize", [False, True])
def test_decoder_layer_teacher_forcing(post_normalize):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, D).astype(np.float32)
    memory = rng.randn(2, 8, D).astype(np.float32)
    pad = np.zeros((2, 8), np.float32)
    pad[1, 3:] = 1.0
    jm, tm, params = _decoder_layer_pair(rng, post_normalize, x, memory)
    causal = np.triu(np.full((5, 5), -1e9, np.float32), 1)[None, None]
    ref, _ = jm.apply({"params": params}, x, self_attention_bias=causal,
                      memory=memory,
                      memory_bias=jnp.asarray(pad * -1e9)[:, None, None, :])
    ours = tm(_t(x), self_attention_bias=layer_utils.
              causal_self_attention_bias(5), memory=_t(memory),
              memory_bias=layer_utils.input_padding_to_bias(_t(pad)))
    _close(ours, ref)


def test_decoder_layer_decode_steps():
    rng = np.random.RandomState(10)
    b, max_len = 2, 5
    xs = rng.randn(max_len, b, 1, D).astype(np.float32)
    memory = rng.randn(b, 6, D).astype(np.float32)
    jm, tm, params = _decoder_layer_pair(rng, False, xs[0], memory)
    zeros = np.zeros((b, max_len, N, D // N), np.float32)
    jcache = {"self": {"keys": jnp.asarray(zeros),
                       "values": jnp.asarray(zeros)}}
    jcache.update(jm.apply({"params": params}, memory,
                           method=jm.memorize_memory))
    with torch.no_grad():
        tcache = {"self": {"keys": _t(zeros.copy()),
                           "values": _t(zeros.copy())}}
        tcache.update(tm.memorize_memory(_t(memory)))
        for t in range(3):
            bias = _step_bias(t, max_len)
            ref, jcache = jm.apply({"params": params}, xs[t],
                                   self_attention_bias=bias, cache=jcache,
                                   decode_step=t)
            ours = tm(_t(xs[t]), self_attention_bias=_t(bias), cache=tcache,
                      decode_step=t)
            _close(ours, ref)


def test_decoder_stack_teacher_forcing_with_flash():
    """Decoder flash path (causal self + cross key lengths) against the
    JAX stack in interpret mode."""
    rng = np.random.RandomState(11)
    kwargs = dict(num_layers=2, hidden_size=D, num_attention_heads=N,
                  filter_size=FILTER, enable_flash_attention=True)
    x = rng.randn(2, 6, D).astype(np.float32)
    memory = rng.randn(2, 9, D).astype(np.float32)
    pad = np.zeros((2, 9), np.float32)
    pad[0, 4:] = 1.0
    jm = JDecoder(**kwargs)
    params = _init(jm, rng, x, memory=memory, memory_padding=pad)
    tm = _port(TDecoder(**kwargs), params)
    ref, _ = jm.apply({"params": params}, x, memory=memory,
                      memory_padding=pad)
    ours, _ = tm(_t(x), memory=_t(memory), memory_padding=_t(pad))
    _close(ours, ref)


@pytest.mark.parametrize("frames,feat,channels,layer_norm", [
    (23, 15, 1, True), (17, 16, 2, True), (9, 11, 1, False)])
def test_audio_conv2d_subsampling(frames, feat, channels, layer_norm):
    """Odd T and F: flax's pad-then-VALID stride-2 convolution equals
    torch's padding=1, and the (F', C) flatten order is kept."""
    rng = np.random.RandomState(frames)
    x = rng.randn(2, frames, feat, channels).astype(np.float32)
    kwargs = dict(embedding_dim=D, channels=4, layer_norm=layer_norm)
    jm = jaudio.AudioConv2dSubsampling(**kwargs)
    params = _init(jm, rng, x)
    tm = _port(taudio.AudioConv2dSubsampling(
        feature_dim=feat, feature_channels=channels, **kwargs), params)
    ref = jm.apply({"params": params}, x)
    ours = tm(_t(x))
    assert ours.shape == ref.shape == (
        2, jaudio.subsampled_length(frames), D)
    _close(ours, ref)


def test_subsampled_length():
    lengths = np.arange(0, 40, dtype=np.int32)
    _close(taudio.subsampled_length(_t(lengths)),
           jaudio.subsampled_length(jnp.asarray(lengths)))
    assert taudio.subsampled_length(1023) == jaudio.subsampled_length(1023)
