"""The registration trainer's device-cached step as one CUDA graph.

On the device-cached path (`RegTrainer.train_iteration` with an `aug` item)
every shape of the step is fixed, and the only host read in it is
cuSOLVER's 3x3 SVD in the Kabsch (it reads its convergence flags). So
`StepGraph` captures the rest of the step once: `device_augment` of both
sides, `NeRFRegTr.forward` with the per-layer Kabsch left at its moments,
`compute_losses`, the gradient, `GuardedAdamW.step`. It then replays it
every step, one host call in the place of some 13,500 launches. After each
replay the host solves every layer's moments, as the forward would
(`rigid_from_moments`), and takes the pose error of the last; no gradient
crosses that split, since the pose is in no loss.

Static inputs, filled before each replay, outside the graph:
  * the cached grids and masks, copied device to device;
  * `pose`, `p_src` and `p_tgt` through pinned host buffers (non_blocking;
    the host waits for the previous upload before it writes them again);
  * the jitter noise, drawn into its buffers from the trainer's generator in
    the eager step's order (src, then tgt).
The static output is one int32 vector: the metrics and the Kabsch moments
(their f32 bits), then the counters `regtr.src_points`, `regtr.tgt_points`
and `regtr.level`. It is cloned once a replay, and the metrics returned are
views of the clone, so that two steps' metrics never alias.

`capture` warms the body up on a side stream (`WARMUP_STEPS` runs, from
the inputs already filled, the optimizer's state put back afterwards),
then captures it. A graph is bound to its inputs' shapes and dtypes, to the
jitter's scale and clip, and to the optimizer object: the trainer builds a
new one when one of them changes (`set_lr_schedule` installs a new
optimizer).
"""
from __future__ import annotations

import math

import torch

from dregnerf_tpu_torch.geometry.kabsch import rigid_from_moments
from dregnerf_tpu_torch.runtime import profiling

SIDES = ("src_grid", "src_mask", "tgt_grid", "tgt_mask")
COUNTERS = ("regtr.src_points", "regtr.tgt_points", "regtr.level")
# one run does the lazy set-up a capture must not meet (cuDNN's and cuBLAS's
# handles and plans); make_graphed_callables' 3 (11 under DDP) serve DDP's
# bucket rebuild, which this step does not have. A run costs 0.3 s.
WARMUP_STEPS = 1
DEVICE_TYPES = ("cuda",)  # where the step is captured


def matrices(item: dict) -> dict:
    """The host 4x4 matrices of a device-cached item: `pose`, `p_src`, `p_tgt`."""
    aug = item["aug"]
    return {"pose": torch.as_tensor(item["pose"]),
            "p_src": torch.as_tensor(aug["p_src"]), "p_tgt": torch.as_tensor(aug["p_tgt"])}


def key(sides: dict, matrices: dict, jitter: tuple) -> tuple:
    """What a graph's work depends on in its inputs: their shapes and dtypes,
    and the jitter's (scale, clip)."""
    return (jitter, *((k, tuple(t.shape), t.dtype) for k, t in {**sides, **matrices}.items()))


def warm_up(body, state: list, steps: int = WARMUP_STEPS) -> torch.Tensor:
    """Runs `body` `steps` times and puts the tensors of `state` back as they
    were; returns the last run's output."""
    saved = [t.clone() for t in state]
    try:
        for _ in range(steps):
            out = body()
    finally:
        for t, s in zip(state, saved):
            t.copy_(s)
    return out


def capture(body, state: list):
    """(graph, its static output): `body` captured as a CUDA graph after a
    warm-up on a side stream that leaves `state` as it found it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up(body, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out


class StepGraph:
    """The static buffers of a trainer's device-cached step and its graph
    (captured at the first `step`). `sides`: the cached grids and masks;
    `matrices`: host tensors `pose`, `p_src`, `p_tgt`; `jitter`: (scale,
    clip), scale 0 for none."""

    def __init__(self, trainer, sides: dict, matrices: dict, jitter: tuple):
        dev = torch.device(trainer.device)
        opt = self.optimizer = trainer.optimizer
        self.state = [opt.flat, opt.mu, opt.nu, opt.count, opt.schedule_count]
        self.key = key(sides, matrices, jitter)
        self.jitter = jitter
        self.inputs = {k: torch.empty_like(sides[k]) for k in SIDES}
        self.matrices = {k: torch.empty(m.shape, dtype=m.dtype, device=dev)
                         for k, m in matrices.items()}
        self.staging = self.uploaded = None
        if dev.type == "cuda":
            self.staging = {k: torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
                            for k, m in matrices.items()}
            self.uploaded = torch.cuda.Event()
        self.noise = None
        if jitter[0]:
            n = sides["src_mask"].shape[0]
            self.noise = {s: torch.empty(n, 3, device=dev) for s in ("src", "tgt")}
        self.graph = self.out = self.layout = None

    def fill(self, sides: dict, matrices: dict, generator: torch.Generator) -> None:
        """The step's inputs into the static buffers, and its noise drawn."""
        for k in SIDES:
            self.inputs[k].copy_(sides[k])
        if self.staging is None:
            for k, m in matrices.items():
                self.matrices[k].copy_(m)
        else:
            self.uploaded.synchronize()  # the previous step's upload has read them
            for k, m in matrices.items():
                self.staging[k].copy_(m)
                self.matrices[k].copy_(self.staging[k], non_blocking=True)
            self.uploaded.record()
        if self.noise is not None:
            for s in ("src", "tgt"):
                torch.randn(self.noise[s].shape, generator=generator, out=self.noise[s])

    def body(self, trainer) -> torch.Tensor:
        """The captured work: the step from the static inputs, packed."""
        from dregnerf_tpu_torch.datasets.register_pairs import device_augment

        scale, clip = self.jitter
        batch = {**self.inputs, "pose": self.matrices["pose"]}
        for s in ("src", "tgt"):
            noise = None if self.noise is None else self.noise[s]
            batch[f"{s}_grid"] = device_augment(self.inputs[f"{s}_grid"], self.inputs[f"{s}_mask"],
                                                self.matrices[f"p_{s}"], noise, scale, clip)
        with profiling.collect({}) as counts:
            metrics = trainer._step([batch], solve_pose=False)
        layout, floats = [], []
        for name, v in metrics.items():
            parts = v if isinstance(v, tuple) else (v,)
            layout.append((name, [tuple(t.shape) for t in parts], isinstance(v, tuple)))
            floats += [t.reshape(-1) for t in parts]
        self.layout = layout
        counters = torch.stack([counts[c][0].to(torch.int32) for c in COUNTERS])
        return torch.cat([torch.cat(floats).view(torch.int32), counters])

    def unpack(self, out: torch.Tensor) -> tuple[dict, dict]:
        """(metrics, counters) as views of a packed output."""
        n = sum(math.prod(s) for _, shapes, _ in self.layout for s in shapes)
        floats = out[:n].view(torch.float32)
        metrics, i = {}, 0
        for name, shapes, is_tuple in self.layout:
            parts = []
            for s in shapes:
                parts.append(floats[i:i + math.prod(s)].view(s))
                i += math.prod(s)
            metrics[name] = tuple(parts) if is_tuple else parts[0]
        return metrics, dict(zip(COUNTERS, out[n:]))

    def step(self, trainer) -> dict:
        """One replay (after the capture, at the first call): the eager
        step's metrics, in its order; counts the counters as it does."""
        if self.graph is None:
            self.graph, self.out = capture(lambda: self.body(trainer), self.state)
            trainer.graph_captures += 1
            profiling.count("regtr.graph_captures", 1)
        self.graph.replay()
        trainer.graph_replays += 1
        profiling.count("regtr.graph_replays", 1)
        packed, counters = self.unpack(self.out.clone())
        for name, v in counters.items():
            profiling.count(name, v)
        metrics = {}
        for name, v in packed.items():
            if name == "pose_moments":
                pose = rigid_from_moments(*v)[-1, 0]
                metrics.update(trainer.pose_metrics(pose, self.matrices["pose"]))
            else:
                metrics[name] = v
        return metrics
