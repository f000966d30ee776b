"""Train a causal LM through the sequence-parallel ring, then generate
from it through the ring-sharded KV-cache decoder -- one parameter set,
both directions. The PyTorch port of
examples/07_lm_train_and_generate.py.

`python examples/torch_port/07_lm_train_and_generate.py` runs on one
card; `--device cpu --host-devices 4` trains over a ring of 4 gloo ranks
on the CPU, and under `torchrun --nproc-per-node 8` over the JAX
example's ("data" 2, "seq" 4) mesh of cards.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import numpy as np
import torch

from idc_models_tpu_torch import collectives, convert
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch.models.core import init_params
from idc_models_tpu_torch.models.lm import (
    AttentionLM, Generator, generate, make_lm_train_step, next_token_loss,
)
from idc_models_tpu_torch.train.state import TrainState, rmsprop
from idc_models_tpu_torch.train.step import (
    make_train_step, replicate, shard_batch,
)

VOCAB, SEQ = 11, 32
STEPS, BATCH = 150, 32
SIZES = dict(embed_dim=32, num_heads=2, num_blocks=2)


def counting_batches(steps: int = STEPS):
    """The task: sequences count upward mod VOCAB (the LM must learn
    succ()); `steps` batches [BATCH, SEQ] int32 from seed 1."""
    rng = np.random.default_rng(1)
    return [((rng.integers(0, VOCAB, (BATCH, 1)) + np.arange(SEQ))
             % VOCAB).astype(np.int32) for _ in range(steps)]


def build_model(world, mesh, params=None):
    """The LM on `mesh` (its ring when the mesh has more than one rank),
    from seed 0 or from a JAX-shaped parameter tree, on the world's
    device."""
    model = AttentionLM(VOCAB, SEQ, mlp_dim=64,
                        mesh=mesh if mesh.size > 1 else None, **SIZES)
    if params is None:
        init_params(model, 0)
    else:
        convert.load_jax(model, params)
    return model.to(world.device)


def train(world, model, mesh, seqs) -> dict:
    """RMSprop at 3e-3 over the batches `seqs`; the last step's
    metrics."""
    state = TrainState(model, rmsprop(model, 3e-3))
    if model.mesh is not None:
        step = make_lm_train_step(state, global_batch=BATCH)
    else:
        step = make_train_step(
            state, next_token_loss,
            mesh=mesh if collectives.initialized() else None)
    replicate(mesh, model)
    for batch in seqs:
        bx = shard_batch(mesh, batch, axis=meshlib.DATA_AXIS,
                         device=world.device)
        m = step(bx, bx)
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"])}


def serve_params(model):
    """What the decoders take: the module on one rank, the whole tree
    gathered from every rank's blocks on a mesh."""
    return model if model.mesh is None else model.gathered_params()


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(data=2, seq=4)        # batch x ring
        model = build_model(world, mesh)
        m = train(world, model, mesh, counting_batches())
        print(f"trained {STEPS} steps: loss={m['loss']:.4f} "
              f"next-token accuracy={m['accuracy']:.3f}")

        params = serve_params(model)
        prompt = [[7, 8, 9]]
        out = generate(params, prompt, 8, t_max=SEQ,
                       cache_dtype=torch.float32, device=world.device,
                       **SIZES)
        print("prompt", prompt[0], "->", out.tolist()[0])
        assert out.tolist()[0] == [(7 + i) % VOCAB for i in range(11)]
        print("generation matches the learned successor pattern")

        # hot serving: a Generator holds the decode programs -- one ring
        # prefill + the decode steps per request; eager PyTorch compiles
        # nothing, so repeated requests trivially recompile nothing
        gen = Generator(params, t_max=SEQ, cache_dtype=torch.float32,
                        device=world.device, **SIZES)
        for start in (3, 5):
            p = [[start, start + 1, start + 2]]
            toks = gen(p, 8).tolist()[0]
            assert toks == [(start + i) % VOCAB for i in range(11)]
        print("Generator served 2 requests, compiled once:",
              gen.cache_sizes(), "(eager PyTorch keeps no compiled "
              "program: every count is 0 by design)")
        return {**m, "generated": out.tolist()[0]}


if __name__ == "__main__":
    main()
