"""AdamW's update as one multi-tensor CUDA kernel a step (U1).

The JAX package's update is ``optax.adamw``, which XLA fuses into the step;
it had no Pallas kernel. :class:`AdamW` is ``torch.optim.AdamW`` with the
same state, hyperparameters, ``state_dict`` and ``load_state_dict``, and a
``step`` that, on CUDA parameters, runs ``csrc/adamw.cu`` once over every
parameter of a group that has a gradient, in place of torch's foreach
passes. The parameters' state is torch's: ``exp_avg`` and ``exp_avg_sq``
zeros like the parameter, made at its first step, and ``step`` a host f32
tensor that advances by one ``torch._foreach_add_``; a parameter whose
gradient is None is skipped and its step does not advance.

- On the CPU the step is torch's own (``torch.optim.AdamW.step``): the
  plain version, which the CPU tests and the parity tests against JAX run.
- On CUDA tensors it launches the kernel or raises: every parameter,
  gradient and moment f32, contiguous and on one device, every gradient
  dense. amsgrad, maximize and the capturable, differentiable and fused
  flags raise too.
- The bias corrections are computed on the host from the step, as torch
  computes them, and passed with the LR, the betas, eps and the decay as
  the kernel's arguments: one launch for each distinct step value in a
  group (one, unless states were loaded at different steps).
- The kernel reads a device table of each tensor's p, g, m and v pointers,
  element count and offset. A group's table is uploaded again only when
  the parameters' or gradients' addresses change, or the moments were
  replaced (a new state object): on the train step's CUDA graph the
  gradients are the graph's own tensors, so one table serves every step;
  gradients made anew each update (eager, accumulated or clipped) rebuild
  it, unless the allocator gave them the same addresses. A table is checked
  (dtypes, contiguity, devices) when it is built.
- The card idles while the host prepares a launch (the update follows the
  guard's fetch), so that work is kept short: a group's parameters with
  gradients and their state (:class:`_Plan`) are kept from one update to
  the next while nothing replaced them, and the step counters advance
  behind the launch.

``launches`` counts kernel launches and ``elements`` the parameter elements
an update wrote (on either path); ``AdamW.table_uploads`` counts tables built.
"""
from __future__ import annotations

import operator

import torch
from torch.optim.optimizer import _get_scalar_dtype

from ._build import load_library

launches = 0
elements = 0

_UNSUPPORTED = ("amsgrad", "maximize", "capturable", "differentiable", "fused")
_GRAD = operator.attrgetter("grad")
_VERSION = operator.attrgetter("_version")
_SPARSE = operator.attrgetter("is_sparse")


def _check(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor) -> None:
    """What the kernel takes: f32 contiguous tensors of p's size on p's CUDA
    device (a sparse gradient is refused before)."""
    for name, t in (("parameter", p), ("gradient", g), ("exp_avg", m),
                    ("exp_avg_sq", v)):
        if t.device.type != "cuda" or t.device != p.device:
            raise ValueError(f"the AdamW kernel takes tensors on one CUDA "
                             f"device; a {name} is on {t.device}, its "
                             f"parameter on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the AdamW kernel takes float32 tensors, got a "
                            f"{t.dtype} {name}")
        if not t.is_contiguous():
            raise ValueError(f"the AdamW kernel takes contiguous tensors, got "
                             f"a {name} of strides {t.stride()}")
        if t.shape != p.shape:
            raise ValueError(f"a {name} of shape {tuple(t.shape)} for a "
                             f"parameter of shape {tuple(p.shape)}")


class _Plan:
    """A group's parameters that have gradients and their AdamW state,
    kept from one update to the next while the optimizer's state object, the
    group's parameters, which of them have gradients and the step counters'
    version counters (any write to a counter moves its version) stay as they
    were; the counters' values are read when they change."""

    def __init__(self, state, members: list, grads: list, ms: list, vs: list,
                 steps: list):
        self.state, self.members = state, list(members)
        self.missing = [g is None for g in grads]
        self.params = [p for p, g in zip(members, grads) if g is not None]
        self.ms, self.vs, self.steps = ms, vs, steps
        self.advanced(list(map(torch.Tensor.item, steps)))

    def advanced(self, values: list[float]) -> None:
        """The step counters now hold ``values`` (and their versions)."""
        self.values = values
        self.versions = list(map(_VERSION, self.steps))

    def holds(self, state, members: list, grads: list) -> bool:
        return (state is self.state and len(members) == len(self.members)
                and all(map(operator.is_, members, self.members))
                and [g is None for g in grads] == self.missing
                and list(map(_VERSION, self.steps)) == self.versions)


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` (decoupled decay) whose ``step`` runs the port's
    kernel on CUDA parameters (module docstring)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.table_uploads = 0
        self._plans: dict[int, _Plan] = {}
        # (group, step slot) -> (plan, rows, device table, chunks, elements)
        self._tables: dict[tuple[int, int], tuple] = {}

    @torch.no_grad()
    def step(self, closure=None):
        """torch's ``step``, on CUDA parameters one kernel launch a group
        and step value."""
        global elements
        if self.param_groups[0]["params"][0].device.type == "cpu":
            with_grad = [p for group in self.param_groups
                         for p in group["params"] if p.grad is not None]
            if any(p.device.type != "cpu" for p in with_grad):
                raise ValueError("the port's AdamW takes the parameters of "
                                 "one optimizer on the CPU or on CUDA, not "
                                 "both")
            elements += sum(p.numel() for p in with_grad)
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for index, group in enumerate(self.param_groups):
            self._group_step(index, group, list(map(_GRAD, group["params"])))
        return loss

    def _group_step(self, index: int, group: dict, grads: list) -> None:
        flags = [k for k in _UNSUPPORTED if group.get(k)]
        if flags:
            raise ValueError(f"the AdamW kernel does not take {flags}")
        members = group["params"]
        plan = self._plans.get(index)
        if plan is None or not plan.holds(self.state, members, grads):
            plan = self._plans[index] = self._plan(members, grads)
        if not plan.params:
            return
        grads = [g for g in grads if g is not None]
        if any(map(_SPARSE, grads)):
            raise ValueError("the AdamW kernel takes dense gradients, got a "
                             "sparse one")
        lists, values = (plan.params, grads, plan.ms, plan.vs), plan.values
        if values.count(values[0]) == len(values):
            slots = [(values[0], lists)]
        else:
            by_value: dict[float, list[int]] = {}
            for i, t in enumerate(values):
                by_value.setdefault(t, []).append(i)
            slots = [(t, tuple([x[i] for i in at] for x in lists))
                     for t, at in by_value.items()]
        after = {}
        for slot, (value, tensors) in enumerate(slots):
            # the step after the increment, in the counters' own dtype
            after[value] = torch.tensor(value + 1,
                                        dtype=plan.steps[0].dtype).item()
            self._launch((index, slot), plan, group, after[value], *tensors)
        # after the launch, so that the host's counting overlaps the kernel
        torch._foreach_add_(plan.steps, torch.tensor(1.0), alpha=1.0)
        plan.advanced([after[t] for t in values])

    def _plan(self, members: list, grads: list) -> _Plan:
        """The group's tensors with gradients and their state, made as
        torch makes it where a parameter has none yet."""
        ms, vs, steps = [], [], []
        for p, g in zip(members, grads):
            if g is None:
                continue
            state = self.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=_get_scalar_dtype())
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            ms.append(state["exp_avg"])
            vs.append(state["exp_avg_sq"])
            steps.append(state["step"])
        return _Plan(self.state, members, grads, ms, vs, steps)

    def _launch(self, key: tuple[int, int], plan: _Plan, group: dict,
                step: float, params, grads, ms, vs) -> None:
        """One kernel launch over the tensors at ``step``, with the scalars
        torch's foreach route computes on the host."""
        global launches, elements
        lr, eps, wd = float(group["lr"]), group["eps"], group["weight_decay"]
        beta1, beta2 = group["betas"]
        table, chunks, numel = self._table(key, plan, params, grads, ms, vs)
        if not chunks:      # every tensor empty
            return
        lib = load_library()
        device = params[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.tic_adamw(table.data_ptr(), len(table), chunks,
                                1 - lr * wd, 1 - beta1, beta2, 1 - beta2,
                                (1 - beta2 ** step) ** 0.5, eps,
                                (lr / (1 - beta1 ** step)) * -1, stream)
        if err:
            raise RuntimeError(f"AdamW kernel launch failed with CUDA error "
                               f"{err} ({len(table)} tensors, {numel} "
                               f"elements)")
        launches += 1
        elements += numel

    def _table(self, key: tuple[int, int], plan: _Plan, params, grads, ms,
               vs) -> tuple[torch.Tensor, int, int]:
        """(device table, chunks, elements) of the tensors, uploaded only
        when the plan, or the parameters' or gradients' addresses, differ
        from the last ones of ``key`` (a parameter keeps its size at its
        address)."""
        address = torch.Tensor.data_ptr
        # a gradient has its parameter's dtype, shape and device (``.grad``
        # refuses any other), so its layout is all that a new one at the same address can
        # change; the moments are the plan's, whose storage nothing but the
        # optimizer's own state replaces
        rows = (list(map(address, params)), list(map(address, grads)),
                list(map(torch.Tensor.is_contiguous, grads)))
        cached = self._tables.get(key)
        if cached is not None and cached[0] is plan and cached[1] == rows:
            return cached[2:]
        for quad in zip(params, grads, ms, vs):
            _check(*quad)
        chunk = load_library().tic_adamw_chunk_elements()
        sizes = list(map(torch.Tensor.numel, params))
        flat, offset = [], 0
        for row in zip(rows[0], rows[1], map(address, ms), map(address, vs),
                       sizes):
            if row[4]:
                flat.extend((*row, offset))
                offset += -(-row[4] // chunk) * chunk
        table = torch.tensor(flat, dtype=torch.int64).view(-1, 6).pin_memory()
        table = table.to(params[0].device, non_blocking=True)
        entry = (table, offset // chunk, sum(sizes))
        self._tables[key] = (plan, rows, *entry)
        self.table_uploads += 1
        return entry
