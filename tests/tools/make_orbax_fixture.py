"""Writes ``tests/fixtures/orbax_jax/``: a checkpoint of the JAX
package's ``save_checkpoint_orbax`` (OCDBT + zarr, zstd-compressed
chunks), for the port's readers on a host without JAX, orbax or
tensorstore (``chip_smoke.py``'s orbax phase reads it on the card and
times the zstd decoder on its frames).

A ``transformer`` with d 64, 2 + 2 layers and a 1,000-word vocabulary,
weights 0.02 x a seeded normal draw (the scale of trained weights), with
a bfloat16 copy of the source embedding table beside them; ``flat.npz`` holds
the same arrays as float32 (the bf16 one widened exactly) for the
bitwise check.

    JAX_PLATFORMS=cpu python tests/tools/make_orbax_fixture.py
"""

import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "tests", "fixtures", "orbax_jax")


def main():
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from neurst_tpu.models.model import build_model
    from neurst_tpu.models.transformer import Transformer
    from neurst_tpu.utils.checkpoints import flatten_params
    from neurst_tpu.utils.orbax_checkpoints import save_checkpoint_orbax

    cfg = Transformer.build_model_args_by_name("transformer_64_2e_2d_4h")
    meta = {"vocab_size": 1000, "eos_id": 1, "bos_id": 2, "unk_id": 3}
    model = build_model(cfg, src_meta=meta, trg_meta=meta)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda v: (0.02 * rng.randn(*v.shape)).astype(np.float32),
        jax.eval_shape(model.init_params, jax.random.PRNGKey(0)))
    tree = {"params": params, "half": jnp.asarray(
        params["input_symbol_modality"]["weights"], jnp.bfloat16)}
    shutil.rmtree(OUT, ignore_errors=True)
    save_checkpoint_orbax(OUT, 7, tree)
    flat = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v)
            for k, v in flatten_params(tree).items()}
    np.savez_compressed(os.path.join(OUT, "flat.npz"), **flat)


if __name__ == "__main__":
    main()
