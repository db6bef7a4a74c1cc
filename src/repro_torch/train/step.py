"""Train step: microbatch gradient accumulation, clipping, optimizer update.

Counterpart of ``repro.train.step``.  ``make_train_step(model)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
the loss's gradients over ``plan.microbatches`` microbatches (the batch's
rows cut in order), summed in ``plan.accum_dtype`` in microbatch order and
divided by their number, the loss averaged; with ``grad_compress="int8_ef"``
the gradients pass the error-feedback compression; then they are clipped
to a global norm of 1.0 and the optimizer updates the parameters in place
(the reference donates its buffers: the same thing).  ``metrics`` holds
the loss and the gradient norm before the clip.  With device ranges on
(``obs.enable_ranges``) the step runs inside ``train.step``, each
microbatch's forward inside ``train.forward`` and its backward (the
forward recomputed under remat included) inside ``train.backward``, the
clip and the update inside ``train.optimizer``.

The parameters are frozen (``requires_grad=False``) outside a step; a step
turns gradients on for its own parameters while it runs, so a serving path
on the same weights builds no autograd graph.

``make_train_step(model, rules)`` is the step on a mesh: the parameters and
the optimizer state are ``DTensor``s laid out by
``parallel.param_sharding.distribute`` under ``rules``, the loss runs under
``rules``, and each gradient is *pinned* to its parameter's placements (a
redistribute, which reduces a ``Partial`` gradient over the batch axes):
after the backward of a single batch, after each microbatch's sum, and —
when ``plan.fused_grad_reduce`` — once more after the accumulation, as the
reference pins its gradients with ``with_sharding_constraint``.  On the
one card's ``(1, 1)`` mesh every placement is ``Replicate()`` and a pin
moves nothing.

``TrainGraph(model, rules=None)`` is the port's
``jax.jit(make_train_step(model, rules), donate_argnums=(0, 1))`` (with
``in_shardings``/``out_shardings`` under rules): the same call, the new
optimizer state written into the tensors it was given, and on ``cuda``
the step captured once as a CUDA graph and replayed for every later call
(its docstring).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.convert import leaf_groups
from repro_torch.kernels._build import add_launches, capture_graph
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.train import compress as C
from repro_torch.train import optimizer as O

CLIP_NORM = 1.0


def param_leaves(cfg, tensors) -> dict:
    """The leaf dict of ``tensors`` (a ``Transformer``, or a dict of its
    parameter names -> tensors): reference leaf path -> the port's tensors,
    in the reference's leaf order."""
    named = tensors if isinstance(tensors, dict) \
        else dict(tensors.named_parameters())
    return {path: [named[n] for n in names]
            for path, names in leaf_groups(cfg)}


def global_norm(leaves: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of a leaf dict, in f32,
    summed leaf by leaf in leaf order."""
    total = 0
    for ts in leaves.values():
        total = total + sum(torch.sum(torch.square(x.float())) for x in ts)
    return torch.sqrt(total)


def make_opt_init(model: Model):
    def opt_init(params):
        leaves = param_leaves(model.cfg, params)
        state = O.opt_init(model.cfg, leaves)
        if model.plan.grad_compress == "int8_ef":
            state["ef"] = C.ef_init(leaves)
        return state
    return opt_init


def _microbatches(batch: dict, n: int) -> list:
    """The batch's rows cut into ``n`` equal microbatches, in order."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not cut into {n} "
                         f"microbatches")
    m = rows // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def pin(g, p):
    """``g`` redistributed to parameter ``p``'s placements (a plain tensor
    unchanged)."""
    from repro_torch.parallel.sharding import is_dtensor
    if not is_dtensor(g):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_grad_step(model: Model, rules=None):
    """``grads_and_loss(params, batch) -> (name -> gradient, loss)``: the
    train step's gradients before compression and the clip, summed over
    the plan's microbatches in ``accum_dtype`` (a single batch: in the
    parameters' dtype) and divided by their number, and the mean loss.
    Under ``rules`` each gradient is pinned to its parameter's placements
    after every microbatch's sum (module docstring)."""
    plan = model.plan
    n_micro = plan.microbatches
    acc_dt = dtype_of(plan.accum_dtype)

    def grads_and_loss(params, batch):
        # each microbatch's gradients land in ``.grad``; where the
        # accumulator's dtype is not the parameter's, they are summed into
        # one of ``acc_dt``
        named = dict(params.named_parameters())
        acc: dict = {}
        lsum = None
        for p in named.values():
            p.grad = None
            p.requires_grad_(True)
        try:
            for mb in _microbatches(batch, n_micro):
                with obs.device_range("train.forward"):
                    loss, _ = model.loss(params, mb, rules)
                with obs.device_range("train.backward"):
                    loss.backward()
                loss = loss.detach()
                lsum = loss if lsum is None else lsum + loss
                for n, p in named.items():
                    if p.grad is None:
                        continue
                    if n_micro > 1 and p.grad.dtype != acc_dt:
                        g = p.grad.to(acc_dt)
                        acc[n] = pin(g if n not in acc else acc[n] + g, p)
                        p.grad = None
                    elif rules is not None:
                        p.grad = pin(p.grad, p)
        finally:
            grads = {}
            for n, p in named.items():
                p.requires_grad_(False)
                grads[n] = acc.get(n, p.grad)
                p.grad = None
        for n, g in grads.items():
            if g is None:               # a parameter the loss never reads
                grads[n] = torch.zeros_like(
                    named[n], dtype=named[n].dtype if n_micro == 1
                    else acc_dt)
            elif n_micro > 1:
                g.div_(n_micro)
            if rules is not None and plan.fused_grad_reduce:
                grads[n] = pin(grads[n], named[n])
        return grads, (lsum / n_micro if n_micro > 1 else lsum)

    return grads_and_loss


def make_train_step(model: Model, rules=None):
    """``train_step(params, opt_state, batch)``; under ``rules`` the step
    on ``DTensor`` parameters and state (module docstring)."""
    cfg, plan = model.cfg, model.plan
    grads_and_loss = make_grad_step(model, rules)

    def train_step(params, opt_state, batch):
        from repro_torch.parallel.sharding import mixed_inputs
        with mixed_inputs(params.embed), obs.device_range("train.step"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        grads, loss = grads_and_loss(params, batch)
        grads = param_leaves(cfg, grads)

        ef_state = None
        if plan.grad_compress == "int8_ef":
            grads, ef_state = C.ef_compress_tree(grads, opt_state["ef"])

        with obs.device_range("train.optimizer"):
            gnorm = global_norm(grads)
            scale = torch.clamp(CLIP_NORM / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for ts in grads.values():
                for g in ts:
                    g.mul_(scale)

            core_state = {k: v for k, v in opt_state.items() if k != "ef"}
            new_state = O.opt_update(cfg, param_leaves(cfg, params), grads,
                                     core_state)
        if ef_state is not None:
            new_state["ef"] = ef_state
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def pin_state(new: dict, like: dict) -> dict:
    """``pin`` over nested dicts: each tensor of ``new`` at the placements
    of the tensor at the same place of ``like``.  ``make_train_step(model,
    rules)`` returns int8 Adam's blocks at the placements their reshapes
    give (``_StridedShard``), where the next step's view of them fails
    torch's sharding propagation (torch 2.13); laid back at the given
    state's placements (the reference's ``out_shardings``) the state
    carries to the next step."""
    return {k: pin_state(v, like[k]) if isinstance(v, dict)
            else pin(v, like[k]) for k, v in new.items()}


def _layout(t) -> str:
    from repro_torch.parallel.sharding import is_dtensor
    if not is_dtensor(t):
        return "a plain tensor"
    return f"{tuple(t.placements)} on {t.device_mesh}"


@torch.no_grad()
def donate(state: dict, new: dict) -> dict:
    """Write each tensor of ``new`` into the tensor at the same place of
    ``state`` (nested dicts of one structure) where they are not the same
    tensor, and return ``state``: the reference's donated buffers, whose
    storage the next step's state reuses.  A ``DTensor`` is written shard
    into shard; one that comes back on another mesh or at other placements
    (or as a plain tensor) raises: the state is never reallocated."""
    from repro_torch.parallel.sharding import is_dtensor
    for k, v in new.items():
        if isinstance(v, dict):
            donate(state[k], v)
            continue
        dst = state[k]
        if v is dst:
            continue
        if is_dtensor(v) or is_dtensor(dst):
            if not (is_dtensor(v) and is_dtensor(dst)) \
                    or v.device_mesh != dst.device_mesh \
                    or tuple(v.placements) != tuple(dst.placements):
                raise ValueError(
                    f"donate: state {k!r} comes back as {_layout(v)}, the "
                    f"given tensor is {_layout(dst)}")
            dst.to_local().copy_(v.to_local())
        else:
            dst.copy_(v)
    return state


class TrainGraph:
    """``make_train_step(model, rules)`` as the reference runs it,
    ``jax.jit(make_train_step(model, rules), donate_argnums=(0, 1))``
    (``src/repro/launch/train.py:47``; under rules with its shardings,
    ``src/repro/launch/dryrun.py:266``): called as
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    Donation: the step writes the parameters in place, as
    ``make_train_step`` does, and writes the new optimizer state (the
    error-feedback buffers and the ``step`` counter included) into the
    tensors of ``opt_state`` (``donate``); it returns the objects it was
    given.

    On ``cuda`` the first call with a ``(params, opt_state)`` pair copies
    the batch into static buffers, runs one eager step on them on a side
    stream (a real step, whose results it returns), which builds and loads
    every kernel library and sets its attributes outside the capture, then
    empties the allocator's cache and captures the step once — forward,
    backward, clip and optimizer update.  Each later call copies its batch
    into the static buffers, replays the graph and returns the metrics in
    the graph's own output tensors, which the next replay overwrites.  A
    batch of another shape or dtype raises.  A call with other ``params``
    or ``opt_state`` objects (after a checkpoint restore) frees the old
    graph and captures the step again.  A capture or a replay that fails
    raises, and so does every later call on the same pair: nothing runs
    eagerly in the graph's place (the eager step before a failed capture
    has run).

    A replay makes no call to a kernel's Python launcher, so the graph
    keeps the launches its capture recorded (``launches``, per
    ``CudaKernel``) and adds them to each kernel's count on every replay;
    the capture's own recorded launches ran nothing and are not counted.
    So too what the capture recorded for ``repro_torch.obs``
    (``recorded``: counters and, with device ranges on, the step's
    ranges), handed on at every replay; None when tracing was off.
    ``capture_ms`` is the capture's wall time (the eager step apart),
    ``pool_bytes`` the device memory the graph's private pool took,
    ``binds`` the number of ``(params, opt_state)`` pairs bound so far.
    With tracing on, the eager step, the capture and each replay's copy
    and launch are the spans ``train.eager_step``, ``train.capture`` and
    ``train.replay`` on ``obs.TRACER``'s clock.

    On the CPU there is no capture: each call is the eager step and the
    write-back, with the same checks of the batch.

    Under ``rules`` the step is ``make_train_step(model, rules)`` on
    ``DTensor`` parameters and state laid out on ``rules.mesh``
    (``parallel.param_sharding.distribute``); the new state is laid out at
    the given state's placements (``pin_state``: the reference's
    ``out_shardings``) and donated shard into shard.  On ``cuda`` the
    capture makes each of the mesh's communicators first
    (``kernels._build.capture_graph``), and the graph holds the forward,
    the backward, the gradient pins, the clip and the optimizer update.
    On the CPU (gloo; the dry run's meta
    tensors over a fake group) each call is the eager step."""

    def __init__(self, model: Model, rules=None):
        self.model = model
        self.rules = rules
        self.step = make_train_step(model, rules)
        self.graph = None
        self.metrics = None
        self.capture_ms = None
        self.pool_bytes = None
        self.launches: dict = {}
        self.recorded = None
        self.binds = 0
        self._bound = None
        self._spec = None
        self._static = None

    def _eager(self, params, opt_state, batch):
        params, new, metrics = self.step(params, opt_state, batch)
        if self.rules is not None:
            new = pin_state(new, opt_state)
        return params, donate(opt_state, new), metrics

    def __call__(self, params, opt_state, batch):
        spec = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        bound = self._bound
        if bound is None or bound[0] is not params \
                or bound[1] is not opt_state:
            return self._bind(params, opt_state, batch, spec)
        if spec != self._spec:
            raise ValueError(f"TrainGraph was bound to batches of "
                             f"{self._spec}, got {spec}")
        if self.model.device.type != "cuda":
            with obs.TRACER.span("train.eager_step"):
                return self._eager(params, opt_state, batch)
        if self.graph is None:
            raise RuntimeError("TrainGraph: the step's capture failed for "
                               "these params and opt_state; nothing runs "
                               "eagerly in its place")
        tr = obs.TRACER
        sp = tr.begin("train.replay") if tr.enabled else None
        for k, v in batch.items():
            self._static[k].copy_(v)
        if self.recorded is not None:
            obs.replaying(self.recorded)
        self.graph.replay()
        add_launches(self.launches)
        if sp is not None:
            sp.finish(tr.clock())
        return params, opt_state, self.metrics

    def _bind(self, params, opt_state, batch, spec):
        # free the old graph and its pool before anything new is made
        self.graph = self.metrics = self._static = self.recorded = None
        self.capture_ms = self.pool_bytes = None
        self.launches = {}
        self._spec = spec
        self.binds += 1
        dev = self.model.device
        self._bound = (params, opt_state)
        tr = obs.TRACER
        if dev.type != "cuda":
            with tr.span("train.eager_step"):
                return self._eager(params, opt_state, batch)
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for k, v in batch.items()}
        for k, v in batch.items():
            static[k].copy_(v)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with tr.span("train.eager_step"):
            with torch.cuda.stream(side):
                out = self._eager(params, opt_state, static)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        with tr.span("train.capture"):
            (self.graph, self.metrics, self.launches, self.capture_ms,
             self.pool_bytes, self.recorded) = capture_graph(
                lambda: self._eager(params, opt_state, static)[2], dev,
                None if self.rules is None else self.rules.mesh)
        self._static = static
        return out
