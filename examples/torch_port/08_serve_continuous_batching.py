"""Serve many users from one LM with the continuous-batching engine --
the multi-user half of the serving story example 07 started. The
PyTorch port of examples/08_serve_continuous_batching.py.

`python examples/torch_port/08_serve_continuous_batching.py` runs on
one card. A trained counting-task LM serves a burst of concurrent
requests through `serve.LMServer`: fixed decode slots, one masked window
per scheduler tick (every busy slot decodes one batch row; finished
slots emit pad and append nothing), FIFO admission with backpressure,
and slot recycling the moment a request hits its stop token or budget.
Every request's output equals a serial `Generator` call -- batching
changes the throughput, not the tokens.
"""

import importlib
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import torch

from idc_models_tpu_torch.models.lm import Generator
from idc_models_tpu_torch.serve import LMServer, Request, poisson_trace

# example 07's model, task and training
lm = importlib.import_module("07_lm_train_and_generate")
VOCAB, SEQ, SIZES = lm.VOCAB, lm.SEQ, lm.SIZES


def make_requests():
    """8 concurrent requests: counting prompts of 3 tokens, budgets of
    6-9."""
    return [Request(id=f"user{i}", prompt=tuple((i + j) % VOCAB
                                                for j in range(3)),
                    max_new_tokens=6 + i % 4)
            for i in range(8)]


def make_trace():
    """A Poisson arrival trace (the standard serving-benchmark
    workload): 6 requests at 200 a second, seed 7."""
    return poisson_trace(6, rate_per_s=200.0, vocab=VOCAB, t_max=SEQ,
                         seed=7)


def make_server(world, params):
    """3 decode slots, windows of 4, float32 caches."""
    return LMServer(params, t_max=SEQ, n_slots=3, window=4,
                    cache_dtype=torch.float32, device=world.device,
                    **SIZES)


def serve(world, params) -> dict:
    """Serve the burst, hold every stream to the counting pattern and to
    its serial Generator call, then a Poisson trace through a fresh
    server. Returns the first server's summary."""
    # a server with 3 decode slots serving 8 concurrent requests:
    # requests queue FIFO, prefill into free slots, and decode TOGETHER
    # in masked windows; each slot recycles the moment its request
    # finishes
    server = make_server(world, params)
    requests = make_requests()
    results = server.run([(0.0, r) for r in requests])
    assert all(r.status == "ok" for r in results)

    # every stream continues its counting prompt -- and equals a serial
    # Generator call with the same prompt
    gen = Generator(params, t_max=SEQ, cache_dtype=torch.float32,
                    device=world.device, **SIZES)
    for r in requests:
        got = server.poll(r.id)
        want = [(r.prompt[-1] + 1 + j) % VOCAB
                for j in range(r.max_new_tokens)]
        assert got.tokens == want, (r.id, got.tokens, want)
        serial = gen([list(r.prompt)],
                     r.max_new_tokens).tolist()[0][len(r.prompt):]
        assert got.tokens == serial
    print(f"served {len(results)} concurrent users on 3 slots, every stream "
          f"= its serial generation, bit for bit")

    s = server.summary()
    print(f"throughput {s['serve_tokens_per_sec']} tok/s, "
          f"TTFT p50 {s['serve_ttft_ms_p50']} ms, "
          f"slot occupancy {s['serve_slot_occupancy']}")

    # the Poisson trace through a fresh server: eager PyTorch compiles
    # no serving program, so the engine's program counts stay at 0 (by
    # design) and nothing is recompiled
    server2 = make_server(world, params)
    sizes = server2.engine.cache_sizes()
    server2.run(make_trace(), realtime=True)
    assert server2.engine.cache_sizes() == sizes
    print("Poisson trace served with zero new compilations:", sizes)
    return s


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        # train succ() (next = tok + 1 mod VOCAB) exactly as in example 07
        mesh = world.mesh(data=2, seq=4)
        model = lm.build_model(world, mesh)
        m = lm.train(world, model, mesh, lm.counting_batches())
        print(f"trained {lm.STEPS} steps: loss={m['loss']:.4f}")
        s = serve(world, lm.serve_params(model))
        return {"loss": m["loss"],
                "tokens_per_sec": s["serve_tokens_per_sec"],
                "ttft_ms_p50": s["serve_ttft_ms_p50"],
                "slot_occupancy": s["serve_slot_occupancy"]}


if __name__ == "__main__":
    main()
