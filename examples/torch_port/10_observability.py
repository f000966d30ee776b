"""See where a serve run spends its time: the observability layer end to
end -- span tracer, metrics registry, Chrome trace export, and the
offline stats rollup. The PyTorch port of examples/10_observability.py.

`python examples/torch_port/10_observability.py` runs on one card. A
small LM serves a burst of requests through the continuous-batching
engine with a tracer armed; the run writes, under
`<temp dir>/idc_obs_example_torch/` (the system's temporary directory,
`TMPDIR` where set):

- `trace.json` -- Chrome trace-event JSON. Open it in Perfetto
  (https://ui.perfetto.dev) or chrome://tracing and you see the
  scheduler's cycles: `serve.tick` spans with `serve.admit` (and the
  chunked `serve.prefill_chunk` calls under it), `serve.collect`
  (waiting for the in-flight window's tokens) and `serve.window` (the
  next window's launches) nested inside.
- the same spans as a jsonl file, summarized by `observe.stats` -- the
  library form of the `python -m idc_models_tpu_torch stats <file>`
  verb.
- the process-wide metrics registry in Prometheus text exposition.
"""

import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import _world  # puts the repo root on sys.path
import torch

from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models.core import init_params
from idc_models_tpu_torch.models.lm import AttentionLM
from idc_models_tpu_torch.observe import (
    REGISTRY, format_summary, summarize_jsonl, trace,
)
from idc_models_tpu_torch.serve import LMServer, poisson_trace

VOCAB, T_MAX = 11, 32
SIZES = dict(embed_dim=32, num_heads=2, num_blocks=2)


def out_dir() -> pathlib.Path:
    """Where the exports land: this example's own directory under the
    temporary directory (never the JAX example's)."""
    return pathlib.Path(tempfile.gettempdir()) / "idc_obs_example_torch"


def make_trace():
    """8 requests arriving at once, prompts of 4-12 tokens, budgets of
    4-8, seed 0."""
    return poisson_trace(8, rate_per_s=1e9, vocab=VOCAB, t_max=T_MAX,
                         prompt_lens=(4, 12), budgets=(4, 8), seed=0)


def serve(world, mesh, params, out: pathlib.Path) -> list:
    """The traced serve run; both exports land on exit."""
    with trace.tracing(chrome_path=out / "trace.json",
                       jsonl_path=out / "spans.jsonl"):
        server = LMServer(params, t_max=T_MAX, n_slots=2, window=4,
                          mesh=mesh, cache_dtype=torch.float32,
                          prefill_chunk=8, device=world.device, **SIZES)
        return server.run(make_trace())


def main(argv=None):
    world = _world.start(__file__, argv, __doc__)
    if world is None:
        return None
    with world:
        mesh = world.mesh(seq=1)
        if mesh.coords is None:
            return None          # a rank past the one-rank mesh
        model = init_params(AttentionLM(VOCAB, T_MAX, mlp_dim=64, **SIZES),
                            0)
        params = convert.to_jax(model)[0]
        out = out_dir()
        results = serve(world, mesh, params, out)

        assert all(r.status == "ok" for r in results)
        print(f"served {len(results)} requests; trace at {out}/trace.json "
              f"(open in https://ui.perfetto.dev)")

        # the offline rollup the `stats` CLI verb prints, over the span
        # export
        print()
        summary = summarize_jsonl(out / "spans.jsonl")
        print(format_summary(summary))

        # the process-wide registry, Prometheus-ready
        print()
        print("metrics registry (Prometheus text exposition):")
        text = REGISTRY.prometheus_text()
        print("\n".join(line for line in text.splitlines()
                        if line.startswith(("#", "serve_"))
                        and "_bucket" not in line))
        return {"served": len(results), "span_records": summary["records"]}


if __name__ == "__main__":
    main()
