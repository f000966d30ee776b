"""Performance attribution: program accounting, step-time attribution,
roofline verdicts, and a compile-churn watchdog, as
``idc_models_tpu/observe/profile.py``.

1. **Program accounting.** `program_report(fn, *args)` runs ONE real
   call of `fn` under a counting dispatch mode and returns a
   `ProgramCost` with the JAX record's fields. There is no compiled
   program to ask, so the numbers are measured:

   - ``flops``: every aten op's FLOPs by the formulas of
     ``torch.utils.flop_counter`` (the registry `FlopCounterMode`
     reads; matmuls, convolutions and attention, forward and backward;
     elementwise ops count zero there);
   - ``bytes_accessed``: the sum of the bytes of every aten op's tensor
     inputs and outputs (views excluded). That is eager traffic: torch
     fuses nothing, so this is what the call moves, where XLA's figure
     is what its fused program moves;
   - on the card, ``peak_hbm_bytes`` is the argument bytes plus the rise
     of ``torch.cuda.max_memory_allocated`` over the call;
     ``argument_bytes`` are the tensors passed in and the `arguments`
     (modules: parameters and buffers; optimizers: their state), and
     ``temp_bytes`` the rise. On the CPU the memory fields are None and
     listed in ``missing``.

   A hand-written kernel launched through ctypes is no aten op, so the
   count cannot see it: callers add its analytic account with
   `augment_cost` (``ops/fused_conv.depthwise_chain_cost``) and file the
   merged record with `register_cost`. `register_program` files a report
   in `PROGRAMS` and the ``program_*{program}`` gauges. While
   `enable_accounting` is on -- inside ``timer.profile_trace``, the
   verbs' ``--profile-dir`` -- `fit` and `run_rounds` count their first
   step or attempt as ``train.step`` / ``fed.round``.

2. **Step-time attribution.** Loops wrap their blocking device waits in
   a ``device.sync`` span (a ``.item()`` or ``torch.cuda.synchronize``).
   `DeviceTimeline` splits each loop span into device-wait vs host-gap
   time; the two fractions sum to 1 by construction.

3. **Roofline verdicts.** `BACKEND_ROOFS` maps device-name substrings to
   (peak dense bf16 TFLOP/s, peak HBM GB/s). `roofline_verdict` combines
   a cost with a measured step time. Unknown devices (the CPU) verdict
   "unknown" unless `register_roof` (CLI ``--peak-tflops`` /
   ``--peak-gbps``) declares the roof.

4. **Compile-churn watchdog.** `arm_watchdog()` registers one
   process-wide listener on dynamo's compile callbacks
   (``torch._dynamo.callback``), so every ``torch.compile`` compile in
   the process is counted under the `compiling(name)` context's name,
   else the innermost open span's, else ``"<unnamed>"``;
   `compiling(None)` suppresses. A named program compiled more than
   `limit` times flags once. The port compiles nothing on its normal
   paths, so a clean run reports no compiles.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings

from idc_models_tpu_torch.observe import metrics_registry as mreg
from idc_models_tpu_torch.observe import trace

# ---------------------------------------------------------------------------
# 1. program accounting
# ---------------------------------------------------------------------------

_MEM_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "generated_code_bytes")


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """One program's cost/memory account. Every numeric field is `None`
    when it was not measured -- consumers branch on `available` /
    `missing` instead of guessing."""

    program: str
    flops: float | None = None
    bytes_accessed: float | None = None
    arithmetic_intensity: float | None = None   # flops / bytes_accessed
    argument_bytes: float | None = None
    output_bytes: float | None = None
    temp_bytes: float | None = None
    alias_bytes: float | None = None
    generated_code_bytes: float | None = None
    peak_hbm_bytes: float | None = None  # arguments + the call's rise
    available: bool = True
    missing: tuple = ()


# metadata queries a dispatch mode sees but that run no kernel
_META_OPS: frozenset | None = None


def _meta_ops():
    global _META_OPS
    if _META_OPS is None:
        import torch

        aten = torch.ops.aten
        _META_OPS = frozenset({
            aten.is_contiguous.default, aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default, torch.ops.prim.device.default})
    return _META_OPS


def _tensors(tree) -> list:
    """The tensors of a tree, a module (parameters and buffers) or an
    optimizer (its state)."""
    import torch
    from torch.utils import _pytree

    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.optim.Optimizer):
        tree = [list(s.values()) for s in tree.state.values()]
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _counting_mode():
    """A TorchDispatchMode that counts FLOPs (``torch.utils.flop_counter``
    formulas) and bytes (tensor inputs + outputs) of every aten op that
    runs a kernel. Built on first use: the class needs torch."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    meta = _meta_ops()

    class _Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in meta:
                return func(*args, **kwargs)
            packet = func._overloadpacket
            if packet not in flop_registry:
                # as FlopCounterMode does: count a composite op through
                # its decomposition, when it has one
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            return out

    return _Counting()


def program_report(fn, *args, name: str = "<program>", arguments=(),
                   **kw):
    """Run ``fn(*args, **kw)`` once -- a real call, with its effects --
    and measure its account. Returns ``(ProgramCost, fn's output)``.

    `arguments` names the state the call reads besides its tensor
    arguments (modules, optimizers, tensor trees), for
    ``argument_bytes``.
    The memory fields are measured on the card (the device of the first
    CUDA tensor among the arguments) and are None on the CPU."""
    import torch

    leaves = _tensors((args, kw)) + [t for o in arguments
                                     for t in _tensors(o)]
    cuda = next((t.device for t in leaves if t.is_cuda), None)
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    mode = _counting_mode()
    with mode:
        out = fn(*args, **kw)
    mem = dict.fromkeys(_MEM_FIELDS)
    peak = None
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        rise = max(0, torch.cuda.max_memory_allocated(cuda) - base)
        mem.update(argument_bytes=float(arg_bytes),
                   output_bytes=float(_tensor_bytes(out)),
                   temp_bytes=float(rise))
        peak = float(arg_bytes + rise)
    flops = float(mode.flops) if mode.flops > 0 else None
    bytes_accessed = float(mode.bytes) if mode.bytes > 0 else None
    missing = tuple(f for f, v in (("flops", flops),
                                   ("bytes_accessed", bytes_accessed))
                    if v is None) + tuple(f for f in _MEM_FIELDS
                                          if mem[f] is None)
    available = flops is not None or bytes_accessed is not None
    if not available:
        warnings.warn(f"program {name!r} ran no counted op -- its "
                      f"ProgramCost is available=False (roofline verdicts "
                      f"for it read 'unknown')", RuntimeWarning,
                      stacklevel=2)
    cost = ProgramCost(
        program=name, flops=flops, bytes_accessed=bytes_accessed,
        arithmetic_intensity=(flops / bytes_accessed
                              if flops and bytes_accessed else None),
        peak_hbm_bytes=peak, available=available, missing=missing, **mem)
    return cost, out


# the process-wide named-program table (train.step, lm.prefill,
# fed.round, ... -- whatever registered this process)
PROGRAMS: dict[str, ProgramCost] = {}
_programs_lock = threading.Lock()


def augment_cost(cost: ProgramCost, *, flops: float = 0.0,
                 bytes_accessed: float = 0.0) -> ProgramCost:
    """Merge hand-computed FLOPs/bytes into a ProgramCost.

    The accounting path for the hand-written kernels: a ctypes launch is
    no aten op, so `program_report` cannot see inside it, and a program
    whose hot ops are such kernels (the fused depthwise chains of
    ``profile --model mobile --depthwise-impl fused``) would under-report.
    Callers add the kernels' analytic account here, then file the merged
    record via `register_cost`; `arithmetic_intensity`, `available` and
    `missing` are recomputed."""
    if not flops and not bytes_accessed:
        return cost
    new_flops = (cost.flops or 0.0) + float(flops)
    new_bytes = (cost.bytes_accessed or 0.0) + float(bytes_accessed)
    missing = tuple(m for m in cost.missing
                    if not (m == "flops" and new_flops)
                    and not (m == "bytes_accessed" and new_bytes))
    return dataclasses.replace(
        cost,
        flops=new_flops if new_flops else None,
        bytes_accessed=new_bytes if new_bytes else None,
        arithmetic_intensity=(new_flops / new_bytes
                              if new_flops and new_bytes else None),
        available=True, missing=missing)


def register_cost(name: str, cost: ProgramCost, *,
                  registry: mreg.MetricsRegistry | None = None
                  ) -> ProgramCost:
    """File a ProgramCost under `name` in `PROGRAMS` and the metrics
    registry (``program_flops{program}`` etc.) -- the shared tail of
    `register_program`, and the entry point for costs that are partly
    hand-computed (`augment_cost`)."""
    if cost.program != name:
        cost = dataclasses.replace(cost, program=name)
    with _programs_lock:
        PROGRAMS[name] = cost
    reg = registry if registry is not None else mreg.REGISTRY
    for metric, help_txt, value in (
            ("program_flops", "FLOPs per execution of a registered "
             "program", cost.flops),
            ("program_bytes_accessed", "bytes moved per execution of a "
             "registered program (eager traffic: every op's tensor "
             "inputs and outputs)", cost.bytes_accessed),
            ("program_peak_hbm_bytes", "resident-footprint peak "
             "(arguments + the call's rise) of a registered program",
             cost.peak_hbm_bytes)):
        if value is not None:
            reg.gauge(metric, help_txt, labels=("program",)).set(
                value, program=name)
    wd = _WATCHDOG
    if wd is not None and cost.flops is not None:
        wd.note_flops(name, cost.flops)
    return cost


def register_program(name: str, fn, *args, arguments=(),
                     registry: mreg.MetricsRegistry | None = None, **kw):
    """`program_report` over one real call of ``fn(*args, **kw)``, filed
    under `name` (the counterpart of both JAX ``register_program`` and
    ``register_jit``: here a program is a callable and its arguments).
    Returns ``(ProgramCost, fn's output)``; the loops call it in place of
    one of their own calls, so accounting adds no extra step."""
    cost, out = program_report(fn, *args, name=name, arguments=arguments,
                               **kw)
    return register_cost(name, cost, registry=registry), out


def registered_programs() -> dict[str, ProgramCost]:
    with _programs_lock:
        return dict(PROGRAMS)


# opt-in switch for the always-on loops (fit, run_rounds): a counted
# call runs under a dispatch mode (slower), so it only runs while armed
# -- inside a ``timer.profile_trace`` window (the verbs' --profile-dir)
_ACCOUNTING = False


def enable_accounting(on: bool = True) -> None:
    global _ACCOUNTING
    _ACCOUNTING = bool(on)


def accounting_enabled() -> bool:
    return _ACCOUNTING


# ---------------------------------------------------------------------------
# 2. step-time attribution
# ---------------------------------------------------------------------------

# the loop spans a timeline splits (nearest-ancestor match, so a
# device.sync under serve.collect under serve.tick attributes to the
# tick) and the device-wait span the instrumented fetch sites emit
LOOP_SPANS = ("profile.step", "train.step", "train.epoch", "serve.tick",
              "fed.round")
DEVICE_SPAN = "device.sync"


class DeviceTimeline:
    """Aggregates a span stream into per-loop device-wait vs host-gap
    time. Feed it `Tracer.records()` (or span-jsonl dicts); `report()`
    returns per-loop totals and fractions and stamps the
    `device_busy_fraction{loop}` gauge."""

    def __init__(self, *, loops=LOOP_SPANS, device_span: str = DEVICE_SPAN,
                 registry: mreg.MetricsRegistry | None = None):
        self.loops = tuple(loops)
        self.device_span = device_span
        self._registry = registry
        self._wall: dict[str, float] = {}
        self._count: dict[str, int] = {}
        self._device: dict[str, float] = {}

    def consume(self, records) -> "DeviceTimeline":
        spans = [r for r in records
                 if r.get("event", "span") == "span"
                 and isinstance(r.get("dur_ms"), (int, float))]
        # span ids are unique within ONE tracer but restart per
        # process, and append-mode run logs can hold several runs — a
        # repeated id starts a new SEGMENT, and parent links never
        # cross segments (joining by raw id across the whole input
        # would walk one run's device.sync into another run's spans)
        segments: list[list[dict]] = []
        seen: set = set()
        for r in spans:
            rid = r.get("id")
            if not segments or (rid is not None and rid in seen):
                segments.append([])
                seen = set()
            if rid is not None:
                seen.add(rid)
            segments[-1].append(r)
        for seg in segments:
            self._consume_segment(seg)
        return self

    def _consume_segment(self, spans: list) -> None:
        by_id = {r["id"]: r for r in spans if r.get("id") is not None}
        loop_set = set(self.loops)
        for r in spans:
            if r.get("name") in loop_set:
                name = r["name"]
                self._wall[name] = self._wall.get(name, 0.0) + r["dur_ms"]
                self._count[name] = self._count.get(name, 0) + 1
        for r in spans:
            if r.get("name") != self.device_span:
                continue
            # nearest loop ancestor (bounded walk guards a cyclic file)
            parent, hops = r.get("parent"), 0
            while parent is not None and hops < 64:
                anc = by_id.get(parent)
                if anc is None:
                    break
                if anc.get("name") in loop_set:
                    nm = anc["name"]
                    self._device[nm] = (self._device.get(nm, 0.0)
                                        + r["dur_ms"])
                    break
                parent, hops = anc.get("parent"), hops + 1

    def report(self) -> dict:
        """{loop: {steps, wall_ms, device_ms, host_gap_ms,
        device_busy_fraction, host_gap_fraction, step_ms_mean}} —
        fractions sum to 1 by construction (device clamped to wall)."""
        out = {}
        reg = (self._registry if self._registry is not None
               else mreg.REGISTRY)
        gauge = reg.gauge(
            "device_busy_fraction",
            "fraction of a loop span's wall the host spent blocked on "
            "device results (device-busy floor; the rest is host gap)",
            labels=("loop",))
        for name, wall in sorted(self._wall.items()):
            dev = min(self._device.get(name, 0.0), wall)
            n = self._count[name]
            frac = dev / wall if wall > 0 else 0.0
            out[name] = {
                "steps": n,
                "wall_ms": round(wall, 3),
                "device_ms": round(dev, 3),
                "host_gap_ms": round(wall - dev, 3),
                "device_busy_fraction": round(frac, 4),
                "host_gap_fraction": round(1.0 - frac, 4),
                "step_ms_mean": round(wall / n, 4) if n else None,
            }
            gauge.set(frac, loop=name)
        return out

    def format_report(self, report: dict | None = None) -> str:
        """Human lines for a `report()` dict — pass one in when the
        caller already computed it (report() re-stamps the gauges)."""
        lines = []
        if report is None:
            report = self.report()
        for name, st in report.items():
            lines.append(
                f"  {name:14s} {st['steps']:>5d} steps  mean "
                f"{st['step_ms_mean']:.3f} ms — device "
                f"{st['device_busy_fraction']:.1%} / host-gap "
                f"{st['host_gap_fraction']:.1%} "
                f"({st['host_gap_ms']:.1f} ms bubble)")
        return "\n".join(lines) if lines else "  (no loop spans seen)"


def trace_mark(tracer) -> float:
    """Monotonic offset (ms) into `tracer`'s epoch right now — pair
    with `records_since` so a timeline covers only a measured region
    (build/warmup spans would otherwise read as one huge host gap)."""
    if tracer is None:
        return 0.0
    return (tracer._clock() - tracer.mono_t0) * 1e3


def records_since(tracer, mark_ms: float) -> list[dict]:
    """The tracer's span records that STARTED at or after `mark_ms`."""
    if tracer is None:
        return []
    return [r for r in tracer.records() if r["t_ms"] >= mark_ms]


# ---------------------------------------------------------------------------
# 3. roofline registry + verdicts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineSpec:
    """One backend's nominal roof: dense bf16 TFLOP/s and HBM GB/s per
    chip (public spec-sheet numbers)."""

    key: str
    peak_tflops: float
    peak_hbm_gbps: float

    @property
    def ridge_intensity(self) -> float:
        """flops/byte where the compute and bandwidth roofs cross —
        programs below it are bandwidth-bound at best."""
        return self.peak_tflops * 1e12 / (self.peak_hbm_gbps * 1e9)


# device-name substring -> roof; longest matching key wins. One row: the
# H100 SXM5 80GB, dense (no sparsity) bf16 tensor-core peak and HBM3
# bandwidth from NVIDIA's H100 data sheet (989 TFLOP/s, 3.35 TB/s). A card
# set below its 700 W limit runs below these peaks.
BACKEND_ROOFS: dict[str, RooflineSpec] = {
    k: RooflineSpec(k, tf, bw) for k, tf, bw in (
        ("h100", 989.0, 3350.0),
    )
}


def register_roof(key: str, peak_tflops: float,
                  peak_hbm_gbps: float) -> RooflineSpec:
    """Add/override a backend roof (e.g. the CLI's --peak-tflops /
    --peak-gbps escape hatch for kinds the table does not know)."""
    if peak_tflops <= 0 or peak_hbm_gbps <= 0:
        raise ValueError(f"roof peaks must be > 0, got "
                         f"({peak_tflops}, {peak_hbm_gbps})")
    spec = RooflineSpec(key.lower(), float(peak_tflops),
                        float(peak_hbm_gbps))
    BACKEND_ROOFS[spec.key] = spec
    return spec


def roofline_for(device) -> RooflineSpec | None:
    """The roof for a device name (``torch.cuda.get_device_name``, or
    anything with a ``device_kind``): longest
    substring match over `BACKEND_ROOFS`, None when unknown."""
    kind = getattr(device, "device_kind", device)
    kind = str(kind).lower()
    best = None
    for key, spec in BACKEND_ROOFS.items():
        if key in kind and (best is None or len(key) > len(best.key)):
            best = spec
    return best


def roofline_verdict(cost: ProgramCost, step_seconds: float | None,
                     device=None, *, spec: RooflineSpec | None = None,
                     n_dev: int = 1) -> dict:
    """Combine a program's cost account with its measured per-step wall
    into a roofline verdict. `cost_analysis` FLOPs/bytes cover the
    whole (multi-device) program, so `n_dev` divides them back to
    per-chip before comparing against the per-chip roofs.

    Returns {verdict, achieved_tflops, achieved_hbm_gbps, mfu,
    hbm_utilization, bound_fraction, ridge_intensity, peak_tflops,
    peak_hbm_gbps} with None where inputs were unavailable; verdict is
    "compute-bound" / "bandwidth-bound" / "unknown"."""
    spec = spec if spec is not None else roofline_for(device)
    achieved_tf = achieved_bw = None
    if step_seconds and step_seconds > 0:
        if cost.flops:
            achieved_tf = cost.flops / n_dev / step_seconds / 1e12
        if cost.bytes_accessed:
            achieved_bw = cost.bytes_accessed / n_dev / step_seconds / 1e9
    out = {
        "verdict": "unknown",
        "achieved_tflops": (round(achieved_tf, 4)
                            if achieved_tf is not None else None),
        "achieved_hbm_gbps": (round(achieved_bw, 3)
                              if achieved_bw is not None else None),
        "mfu": None, "hbm_utilization": None, "bound_fraction": None,
        "ridge_intensity": None, "peak_tflops": None,
        "peak_hbm_gbps": None,
    }
    if spec is None:
        return out
    out["peak_tflops"] = spec.peak_tflops
    out["peak_hbm_gbps"] = spec.peak_hbm_gbps
    out["ridge_intensity"] = round(spec.ridge_intensity, 2)
    if achieved_tf is not None:
        out["mfu"] = round(achieved_tf / spec.peak_tflops, 4)
    if achieved_bw is not None:
        out["hbm_utilization"] = round(achieved_bw / spec.peak_hbm_gbps,
                                       4)
    if cost.arithmetic_intensity is not None:
        compute_bound = (cost.arithmetic_intensity
                         >= spec.ridge_intensity)
        out["verdict"] = ("compute-bound" if compute_bound
                          else "bandwidth-bound")
        out["bound_fraction"] = (out["mfu"] if compute_bound
                                 else out["hbm_utilization"])
    return out


# ---------------------------------------------------------------------------
# 4. compile-churn watchdog
# ---------------------------------------------------------------------------

_SUPPRESS = object()          # compiling(None): accounting, not churn
UNNAMED = "<unnamed>"
_tls = threading.local()


class _CompileName:
    """Reentrant thread-local program-name context for compile events
    (the compile callbacks carry no identity of their own)."""

    __slots__ = ("name", "_prev")

    def __init__(self, name):
        self.name = _SUPPRESS if name is None else name

    def __enter__(self):
        self._prev = getattr(_tls, "program", None)
        _tls.program = self.name
        return self

    def __exit__(self, *exc):
        _tls.program = self._prev
        return None


def compiling(name: str | None) -> _CompileName:
    """Name every compile observed inside the block (`None` suppresses
    recording — accounting copies must not read as churn)."""
    return _CompileName(name)


class CompileWatchdog:
    """Records every observed compile (program name, seconds, flops
    when a registration supplied them) and flags CHURN: any program
    compiled more than `limit` times — the recompile-loop failure mode
    where a shape/dtype varies per call and every "cached" dispatch
    silently recompiles."""

    def __init__(self, *, limit: int = 5,
                 registry: mreg.MetricsRegistry | None = None):
        if limit < 1:
            raise ValueError(f"churn limit must be >= 1, got {limit}")
        self.limit = int(limit)
        self._lock = threading.Lock()
        self.programs: dict[str, dict] = {}
        self.flagged: list[str] = []
        reg = registry if registry is not None else mreg.REGISTRY
        self._m_compiles = reg.counter(
            "compiles_total", "compiles observed "
            "process-wide while the watchdog is armed",
            labels=("program",))
        self._m_seconds = reg.counter(
            "compile_seconds_total", "wall seconds spent in observed "
            "compiles")
        self._m_churn = reg.counter(
            "compile_churn_flagged_total", "programs flagged for "
            "compile churn (compiled more than the configured limit)",
            labels=("program",))

    def on_compile(self, program: str, seconds: float = 0.0) -> None:
        with self._lock:
            st = self.programs.setdefault(
                program, {"count": 0, "seconds": 0.0, "flops": None})
            st["count"] += 1
            st["seconds"] += seconds
            # churn only fires for NAMED programs: the unnamed bucket
            # aggregates unrelated one-shot compiles (model inits,
            # data placement, digests) whose combined count says
            # nothing about any one program recompiling — flagging it
            # would false-positive on every cold start
            fire = (program != UNNAMED
                    and st["count"] > self.limit
                    and program not in self.flagged)
            if fire:
                self.flagged.append(program)
            count = st["count"]
        self._m_compiles.inc(program=program)
        self._m_seconds.inc(max(seconds, 0.0))
        trace.point("compile", program=program,
                    seconds=round(seconds, 6))
        if fire:
            self._m_churn.inc(program=program)
            warnings.warn(
                f"compile churn: program {program!r} compiled {count} "
                f"times (> limit {self.limit}) — some shape/dtype is "
                f"varying per call, so every dispatch pays a fresh "
                f"compile instead of the cache (bucket the shape, pin "
                f"the dtype, or raise the limit if this growth is "
                f"expected)", RuntimeWarning, stacklevel=3)

    def note_flops(self, program: str, flops: float) -> None:
        with self._lock:
            st = self.programs.setdefault(
                program, {"count": 0, "seconds": 0.0, "flops": None})
            st["flops"] = flops

    def report(self) -> dict:
        with self._lock:
            programs = {k: dict(v) for k, v in self.programs.items()}
            flagged = list(self.flagged)
        return {
            "limit": self.limit,
            "total_compiles": sum(v["count"] for v in programs.values()),
            "compile_seconds_total": round(
                sum(v["seconds"] for v in programs.values()), 4),
            "programs": programs,
            "flagged": flagged,
        }


_WATCHDOG: CompileWatchdog | None = None
_arm_lock = threading.Lock()


def _program_name():
    name = getattr(_tls, "program", None)
    if name is None:
        tr = trace.get_tracer()
        if tr is not None:
            stack = tr._stack()
            if stack:
                name = stack[-1].name
    return name


def _compile_start(*args) -> None:
    if _WATCHDOG is None:
        return
    _tls.compile_t0 = time.perf_counter()


def _compile_end(*args) -> None:
    wd = _WATCHDOG
    t0 = getattr(_tls, "compile_t0", None)
    _tls.compile_t0 = None
    if wd is None or t0 is None:
        return
    name = _program_name()
    if name is _SUPPRESS:
        return
    wd.on_compile(name or UNNAMED, seconds=time.perf_counter() - t0)


def arm_watchdog(*, limit: int = 5,
                 registry: mreg.MetricsRegistry | None = None
                 ) -> CompileWatchdog:
    """Install a process-wide `CompileWatchdog`. The dynamo start/end
    compile callbacks are registered once (and again after a
    ``torch._dynamo.reset()``, which clears them); when no watchdog is
    armed they are a one-comparison no-op. Returns the armed watchdog;
    `disarm_watchdog()` ends the observation window."""
    global _WATCHDOG
    wd = CompileWatchdog(limit=limit, registry=registry)
    with _arm_lock:
        try:
            from torch._dynamo.callback import callback_handler

            if _compile_start not in callback_handler.start_callbacks:
                callback_handler.register_start_callback(_compile_start)
                callback_handler.register_end_callback(_compile_end)
        except (ImportError, AttributeError) as e:
            warnings.warn(
                f"dynamo compile callbacks unavailable ({e}); the compile "
                f"watchdog will only see compiles reported explicitly via "
                f"on_compile()", RuntimeWarning, stacklevel=2)
        _WATCHDOG = wd
    return wd


def disarm_watchdog() -> None:
    global _WATCHDOG
    _WATCHDOG = None


def watchdog() -> CompileWatchdog | None:
    return _WATCHDOG


# ---------------------------------------------------------------------------
# frozen jsonl record shapes (profile_program / profile_step)
# ---------------------------------------------------------------------------

def program_record(cost: ProgramCost, roofline: dict | None = None,
                   step_ms: float | None = None,
                   device_kind: str | None = None) -> dict:
    """The `profile_program` jsonl payload (minus ts/event, which the
    JsonlLogger owns) — ONE construction site so the frozen schema in
    tests/test_observability.py is enforced everywhere."""
    rl = roofline or {}
    return {
        "program": cost.program,
        "flops": cost.flops,
        "bytes_accessed": cost.bytes_accessed,
        "arithmetic_intensity": (round(cost.arithmetic_intensity, 4)
                                 if cost.arithmetic_intensity is not None
                                 else None),
        "argument_bytes": cost.argument_bytes,
        "output_bytes": cost.output_bytes,
        "temp_bytes": cost.temp_bytes,
        "peak_hbm_bytes": cost.peak_hbm_bytes,
        "generated_code_bytes": cost.generated_code_bytes,
        "available": cost.available,
        "step_ms": round(step_ms, 4) if step_ms is not None else None,
        "verdict": rl.get("verdict", "unknown"),
        "achieved_tflops": rl.get("achieved_tflops"),
        "achieved_hbm_gbps": rl.get("achieved_hbm_gbps"),
        "mfu": rl.get("mfu"),
        "hbm_utilization": rl.get("hbm_utilization"),
        "bound_fraction": rl.get("bound_fraction"),
        "ridge_intensity": rl.get("ridge_intensity"),
        "peak_tflops": rl.get("peak_tflops"),
        "peak_hbm_gbps": rl.get("peak_hbm_gbps"),
        "device_kind": device_kind,
    }


def step_record(loop: str, stats: dict) -> dict:
    """The `profile_step` jsonl payload from one `DeviceTimeline`
    report row — same one-construction-site discipline."""
    return {
        "loop": loop,
        "steps": stats["steps"],
        "wall_ms": stats["wall_ms"],
        "device_ms": stats["device_ms"],
        "host_gap_ms": stats["host_gap_ms"],
        "device_busy_fraction": stats["device_busy_fraction"],
        "host_gap_fraction": stats["host_gap_fraction"],
        "step_ms_mean": stats["step_ms_mean"],
    }


def format_program(rec: dict) -> str:
    """One human line per profile_program record (CLI + stats share
    it)."""
    bits = [f"  {rec['program']:14s}"]
    if rec.get("flops"):
        bits.append(f"{rec['flops'] / 1e9:8.2f} GFLOP")
    if rec.get("bytes_accessed"):
        bits.append(f"{rec['bytes_accessed'] / 1e9:7.3f} GB moved")
    if rec.get("arithmetic_intensity") is not None:
        bits.append(f"intensity {rec['arithmetic_intensity']:.1f}")
    if rec.get("peak_hbm_bytes"):
        bits.append(f"peak {rec['peak_hbm_bytes'] / 2**30:.2f} GiB")
    if not rec.get("available", True):
        bits.append("(backend reported no analysis)")
    v = rec.get("verdict", "unknown")
    if v != "unknown":
        frac = rec.get("bound_fraction")
        roof = ("peak FLOP/s" if v == "compute-bound"
                else "peak HBM bytes/s")
        at = f" at {frac:.2f} of {roof}" if frac is not None else ""
        extra = ""
        if rec.get("mfu") is not None:
            extra = (f" (mfu {rec['mfu']:.3f}, hbm "
                     f"{rec.get('hbm_utilization')})")
        bits.append(f"-> {v}{at}{extra}")
    elif rec.get("step_ms") is not None:
        bits.append("-> unknown roof (pass --peak-tflops/--peak-gbps "
                    "or register_roof)")
    return " ".join(bits)
