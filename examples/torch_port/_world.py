"""What the PyTorch example scripts share: the command line each one
takes, the world it runs in, and the rule that sizes its meshes.

Every script takes

- ``--device {cuda,cpu}`` (default ``cuda``, as the verbs): without a
  card and without ``--device cpu`` it raises, never falling back to the
  CPU by itself;
- ``--host-devices N`` (the JAX CLI's flag): 0, the default, runs this
  process alone (one card, or one CPU process); N > 1 starts a pod of N
  gloo ranks on the CPU running the same script
  (``mesh.launch_cpu_pod(..., script=)``). Under ``torchrun`` a script
  joins the world torchrun gives it.

The JAX examples fake a pod of 8 devices (``force_cpu_pod(8)``) and
hard-code their layouts for it. Here a mesh takes its sizes from the
world it is started in (`mesh_sizes`): each axis, innermost first, gets
the greatest common divisor of the JAX example's size and the ranks
still free. A world of 8 gives the JAX layouts (("data" 2, "seq" 4),
("data" 2, "model" 4), "client" 8, "seq" 8); a world of 4 gives
("data" 1, "seq" 4); one card gives 1 x 1. The worlds this fills are
the divisors of 8; any other world is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from idc_models_tpu_torch import collectives, resolve_device  # noqa: E402
from idc_models_tpu_torch import mesh as meshlib  # noqa: E402

# the JAX examples' virtual pod
JAX_POD = 8


def mesh_sizes(axes: dict[str, int], world: int) -> dict[str, int]:
    """The sizes of `axes` (the JAX example's layout on its pod of 8,
    outermost first) in a world of `world` ranks: innermost first, each
    axis the gcd of its JAX size and the ranks left."""
    if JAX_POD % world:
        raise SystemExit(f"the examples run on a world that divides the "
                         f"JAX examples' pod of {JAX_POD} (1, 2, 4 or 8 "
                         f"ranks), got {world}")
    sizes, left = {}, world
    for name, size in reversed(axes.items()):
        sizes[name] = math.gcd(size, left)
        left //= sizes[name]
    return {name: sizes[name] for name in axes}


class World:
    """The ranks a script runs on: its device, the world's size and this
    rank. A context: inside it a rank other than 0 prints nothing, and
    on a clean exit the world this script joined is taken down."""

    def __init__(self, device: torch.device, joined: bool):
        self.device = device
        self.joined = joined
        self.size = collectives.axis_size()
        self.rank = collectives.axis_index()
        self._stack = contextlib.ExitStack()

    def mesh(self, **axes: int) -> meshlib.Mesh:
        """A mesh of the JAX example's `axes` (sizes on its pod of 8,
        outermost first), sized for this world by `mesh_sizes`. Every
        rank must call it, in the same order."""
        return meshlib.make_mesh(mesh_sizes(axes, self.size))

    def __enter__(self) -> "World":
        if self.rank:
            sink = self._stack.enter_context(open(os.devnull, "w"))
            self._stack.enter_context(contextlib.redirect_stdout(sink))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stack.close()
        if exc_type is None and self.joined:
            meshlib.leave_world()


def start(script: str, argv: list[str] | None, doc: str | None = None
          ) -> World | None:
    """Parse the command line, then start the world: a pod of
    ``--host-devices`` ranks running `script` (None here: this process
    only relays rank 0's output), or this process's place in the world
    it was started in."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(
        prog=Path(script).name,
        description=(doc or "").strip().splitlines()[0] if doc else None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default cuda; without a card pass "
                        "--device cpu)")
    p.add_argument("--host-devices", type=int, default=0,
                   help="run a pod of N gloo ranks on the CPU (0: this "
                        "process alone)")
    ns = p.parse_args(argv)
    if ns.host_devices < 0:
        raise SystemExit(f"--host-devices {ns.host_devices} must be >= 0 "
                         f"(0: this process alone)")
    if ns.host_devices > 1 and not meshlib.in_cpu_pod():
        meshlib.launch_cpu_pod(ns.host_devices, argv, script=script)
        return None
    # the ranks of a CPU pod run on the CPU
    device = resolve_device("cpu" if ns.host_devices else ns.device)
    joined = meshlib.join_world()
    if device.type == "cuda":
        # torchrun's ranks each took their card as they joined
        device = torch.device("cuda", torch.cuda.current_device())
    return World(device, joined)
