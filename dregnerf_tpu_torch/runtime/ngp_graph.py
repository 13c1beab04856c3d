"""The NGP trainer's single-device step as one CUDA graph per ray bucket.

On one CUDA device with no mesh, every shape of `NGPTrainer.train_iteration`'s
step is set by its ray bucket: the sample buffer has `RenderConfig.buffer_size`
rows whatever the rays yield, the run-length backward picks its branch on the
device, and K1p bounds its rows by a device count. So `StepGraphs` captures
the step once per bucket and replays it after, one host call in the place of
some 500-800 launches: the pixel gather and blend, `rays_from_pixels`, the
march, the field, the compositor, the Huber loss, `loss.backward()` (K1p, the
run-length backward and K2p's, or K6's backward) and Adam's update. A graph
is keyed by its draws' shapes and dtypes; a trainer's graphs share one memory
pool, as they never run at once and each replay's output is cloned before
the next replay.

Outside the graph, eager:
  * the occupancy update (every 16th step), which the trainer writes in
    place into the grid tensors that the graph reads;
  * the draws, copied device to device into the static buffers when given,
    else drawn into them from the trainer's ray generator in
    `draw_step_inputs`' order (the eager step's random stream);
  * the learning rate: on the card Adam runs with `capturable=True` and one
    device learning rate, which the multistep schedule writes before each
    replay, so that no step of the schedule needs a new capture;
  * the bucket feedback's host read (every 8th step), after the replay.

The static output is one byte vector: the step's metrics (`loss`, `psnr`,
`sq`, `n_samples`, `alive_rays`), then the device values of the counters the
step counts (`ngp.live_samples`, `rle.direct`); the counters of host numbers
(`ngp.sample_buffer`, `rle.calls`, `hash.encode_calls`, `hash.kernel_calls`,
`hash.rows`) are the capture's. After each replay every counter is counted
with that replay's values, as the eager step counts them.
`ngp.graph_captures` and `ngp.graph_replays` count the captures and replays
(host ints; also `NGPTrainer.graph_captures` / `.graph_replays`).

The kernel wrappers' launch counters (`launch_counters`) count the host's
launches where they launch: a capture's warm-up and its recording each
launch one step's, a replay none. What the replays ran is a derived number,
kept apart in `NGPTrainer.replayed_launches`: each replay counted with what
its graph's recording launched (`StepGraph.launched`).

`capture` warms the body up once on a side stream (reg_graph's `warm_up`,
which puts the parameters and Adam's state back), then records it into the
trainer's pool. Off the card the optimizer is left as it is; the tests run
this path there with the capture stood in for.
"""
from __future__ import annotations

import torch

from dregnerf_tpu_torch.runtime import profiling
from dregnerf_tpu_torch.runtime.reg_graph import warm_up

DEVICE_TYPES = ("cuda",)  # where the step is captured
METRICS = ("psnr", "sq", "n_samples", "alive_rays", "loss")  # the eager step's order


def engages(trainer) -> bool:
    """Whether the trainer's step runs as a graph: on a device of
    DEVICE_TYPES, with no mesh (the data-parallel step stays eager)."""
    return torch.device(trainer.device).type in DEVICE_TYPES and trainer.mesh is None


def launch_counters() -> dict:
    """(wrapper, attribute) of each kernel launch counter a step may
    advance, by the kernel's name."""
    from dregnerf_tpu_torch.ops import gather_rows, hash_encoding, scatter_add

    return {"scatter_add": (scatter_add.scatter_add, "launches"),
            "scatter_add_bf16": (scatter_add.scatter_add_bf16, "launches"),
            "gather_rows": (gather_rows.gather_rows, "launches"),
            "hash_grid_fwd": (hash_encoding.hash_encode, "launches"),
            "hash_grid_bwd": (hash_encoding.hash_encode, "grad_launches")}


def launches() -> dict[str, int]:
    """The host launches each kernel's wrapper has counted, by kernel."""
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


def capture(body, state: list, pool):
    """(graph, its static output): reg_graph.capture with the graph's memory
    in `pool`, which a trainer's bucket graphs share."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm_up(body, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    return graph, out


def pack(values: list) -> tuple[torch.Tensor, list]:
    """One uint8 vector of the tensors `values`, wider elements first so that
    each lies aligned for its dtype, and the layout `unpack` reads."""
    layout, parts, at = [None] * len(values), [], 0
    for i in sorted(range(len(values)), key=lambda i: -values[i].element_size()):
        v = values[i].detach()
        n = v.numel() * v.element_size()
        layout[i] = (at, n, v.dtype, tuple(v.shape))
        parts.append(v.reshape(-1).view(torch.uint8))
        at += n
    return torch.cat(parts), layout


def unpack(out: torch.Tensor, layout: list) -> list:
    """The tensors of a packed vector, as views of it."""
    return [out[at:at + n].view(dtype).view(shape) for at, n, dtype, shape in layout]


def _make_capturable(optimizer, device) -> None:
    """Turns Adam `optimizer` capturable with one learning rate on `device`
    (its counts move there too)."""
    lr = torch.tensor(float(optimizer.param_groups[0]["lr"]), device=device)
    for group in optimizer.param_groups:
        group["capturable"] = True
        group["lr"] = lr
    for state in optimizer.state.values():
        if "step" in state:
            state["step"] = state["step"].to(device)


def _init_state(optimizer, params: list) -> None:
    """Adam's state of each parameter that has none, as its first update
    would make it (so that the warm-up can put it back)."""
    for p in params:
        if not optimizer.state[p]:
            count = p.device if optimizer.param_groups[0]["capturable"] else "cpu"
            optimizer.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=count),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


class StepGraph:
    """One bucket's static draws, its graph and static output."""

    def __init__(self, spec, device):
        from dregnerf_tpu_torch.runtime.ngp_trainer import StepDraws

        self.draws = StepDraws(*(torch.empty(shape, dtype=dtype, device=device)
                                 for shape, dtype in spec))
        self.graph = self.out = self.layout = None
        self.counters, self.host_counts, self.launched = [], {}, {}

    def body(self, trainer) -> torch.Tensor:
        """The captured work: the step from the static draws, packed."""
        from dregnerf_tpu_torch.runtime.ngp_trainer import step_loss

        before = launches()
        with profiling.collect({}) as counts:
            loss, metrics = step_loss(
                trainer.params, trainer.model_config, trainer.render_config, trainer.grid,
                trainer.aabb, trainer.images, trainer.c2ws, trainer.K, self.draws,
                trainer.scene.synthetic, trainer.scene.opengl, trainer.field,
                trainer.timestamps)
            with profiling.annotate("ngp.backward"):
                loss.backward()
            metrics["loss"] = loss.detach()
            with profiling.annotate("ngp.optimizer"):
                trainer.apply_gradients(None)
        self.launched = {k: v - before[k] for k, v in launches().items()}
        self.counters, self.host_counts, device_values = [], {}, []
        for name, values in counts.items():
            for v in values:
                if isinstance(v, torch.Tensor):
                    self.counters.append(name)
                    device_values.append(v)
                else:
                    self.host_counts[name] = self.host_counts.get(name, 0) + v
        out, self.layout = pack([metrics[k] for k in METRICS] + device_values)
        return out


class StepGraphs:
    """A trainer's step graphs, one per bucket, captured at the bucket's first
    step, with their shared pool, the optimizer they update (made
    capturable on the card) and the state the warm-up puts back."""

    def __init__(self, trainer):
        opt = self.optimizer = trainer.optimizer
        dev = torch.device(trainer.device)
        if dev.type == "cuda":
            _make_capturable(opt, dev)
        params = [p for group in opt.param_groups for p in group["params"]]
        _init_state(opt, params)
        self.state = [p.detach() for p in params] + [
            opt.state[p][k] for p in params for k in ("exp_avg", "exp_avg_sq", "step")]
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.graphs: dict = {}

    def step(self, trainer, step: int, bucket: int, draws=None) -> dict:
        """Step `step` on `draws` (else drawn here at `bucket` rays) as one
        replay, after the capture at the bucket's first step: the eager
        step's metrics in its order, its counters counted as it counts them."""
        from dregnerf_tpu_torch.runtime.ngp_trainer import draw_spec, draw_step_inputs, set_lr

        spec = (draw_spec(bucket) if draws is None
                else tuple((tuple(t.shape), t.dtype) for t in draws))
        key = tuple((tuple(shape), dtype) for shape, dtype in spec)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = StepGraph(key, trainer.device)
        if draws is None:
            scene = trainer.scene
            draw_step_inputs(trainer.ray_generator, bucket, scene.num_images, scene.height,
                             scene.width, trainer.device, out=g.draws)
        else:
            for buf, t in zip(g.draws, draws):
                buf.copy_(t)
        set_lr(self.optimizer, trainer.lr_at(step))
        if g.graph is None:
            g.graph, g.out = capture(lambda: g.body(trainer), self.state, self.pool)
            trainer.graph_captures += 1
            profiling.count("ngp.graph_captures", 1)
        g.graph.replay()
        trainer.graph_replays += 1
        profiling.count("ngp.graph_replays", 1)
        values = unpack(g.out.clone(), g.layout)
        for name, v in zip(g.counters, values[len(METRICS):]):
            profiling.count(name, v)
        for name, v in g.host_counts.items():
            profiling.count(name, v)
        trainer.replayed_launches = {k: trainer.replayed_launches.get(k, 0) + v
                                     for k, v in g.launched.items()}
        return dict(zip(METRICS, values))
