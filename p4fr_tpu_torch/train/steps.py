"""Training and validation steps, port of ``p4fr_tpu/train/steps.py``.

- loss: cross-entropy of ``logits[:, t]`` against ``text[:, t+1]``, pad
  targets ignored, the mean over the rest, in f32;
- per batch the trainer flips a coin against the teacher-forcing ratio and
  runs EITHER the teacher-forced pass over ``text[:, :-1]`` OR the
  AR-sampled pass (argmax feedback, gradients through the cached layer
  outputs; the argmax token carries none) over ``L - 1`` steps;
- the optimizer clips by global norm as optax does (``max_norm / norm``
  only where ``norm >= max_norm``, no epsilon), per parameter group, and
  reads each group's learning rate (and Adam's beta1) from its schedule at
  the number of updates made so far, before the update;
- its state reads and writes optax's tree (``ScheduledOptimizer.
  optax_state`` / ``load_optax_state``), the layout of the JAX trainer's
  ``opt_state`` for each optimizer it builds (``OptaxLayout``).

Training runs through the plain modules (cuDNN and cuBLAS on the card); the
compute type is ``torch.autocast`` over the forward, with f32 master
weights, f32 optimizer state and the loss in f32. Validation
(``make_eval_step``) and a distillation teacher (``train/distillation.py``)
run ``greedy_logits``: the model in eval mode, the encoder through kernel 2
and each AR step through kernel 3 (``decoding.fast_step``) over fused
weights read from the current parameters (an ASTER model: its fused LSTM
step, ``decoding.fast_aster``), or every kernel's plain version with
``plain=True``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from p4fr_tpu_torch.decoding.fast_aster import FastAster, FastAsterCell, aster_step
from p4fr_tpu_torch.decoding.fast_step import decode_buffers, fast_decode_step
from p4fr_tpu_torch.infer.single import build_fast
from p4fr_tpu_torch.ops.decoder_layer import LayerWeights
from p4fr_tpu_torch.train.schedules import Schedule
from p4fr_tpu_torch.utils.convert import _set_path

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def autocast(device: torch.device, dtype: torch.dtype):
    """The forward's compute type: autocast for bf16, nothing for f32."""
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def cross_entropy_ignore_pad(logits: torch.Tensor, targets: torch.Tensor,
                             pad_id: int, data_axis=None) -> torch.Tensor:
    """Mean CE over non-pad targets. logits [B, L, V], targets [B, L].
    ``data_axis`` (a mesh's, ``parallel.mesh.Axis``): the mean over the
    global batch, the numerator and the token count summed over the ranks
    (each shard holds its own count of pad targets)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    valid = (targets != pad_id).float()
    total, count = (nll * valid).sum(), valid.sum()
    if data_axis is not None:
        total, count = data_axis.sum(torch.stack([total, count])).unbind()
    return total / count.clamp_min(1.0)


def teacher_forced_logits(model, images: torch.Tensor, text_in: torch.Tensor
                          ) -> torch.Tensor:
    return model(images, text_in)


def ar_sampled_logits(model, images: torch.Tensor, num_steps: int,
                      picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The AR pass with argmax feedback over the module's own step ->
    logits [B, num_steps, V]; differentiable through every step's cached
    layer outputs. ``picks`` [B, >= num_steps - 1] replays another run's
    argmax picks in place of this run's (a pick carries no gradient), so
    that two devices differentiate one graph."""
    src = model.encode(images)
    src_kv = model.precompute_src(src)
    cache = model.init_decode_cache(images.shape[0], num_steps)
    token = torch.full((images.shape[0],), model.sos_id, dtype=torch.int64,
                       device=images.device)
    logits = []
    for t in range(num_steps):
        step_logits = model.decode_step(token, t, src_kv, cache)
        logits.append(step_logits)
        token = step_logits.argmax(dim=-1) if picks is None else picks[:, t]
    return torch.stack(logits, dim=1)


class OptaxLayout(NamedTuple):
    """Where the JAX trainer's optax state keeps what a ``ScheduledOptimizer``
    keeps (``p4fr_tpu/train/steps.py::build_optimizer``, ``dual_opt.py::
    build_dual_optimizer``): ``name`` adam, adamw or adadelta; ``clip``, a
    ``clip_by_global_norm`` chained before it; ``inject``, the Adam family
    under ``inject_hyperparams`` with a beta1 schedule (``weight_decay`` is
    then one of its hyperparameters); ``labels``, the ``multi_transform``
    label of each parameter group (None: one chain over every parameter),
    each group's chain an ``optax.chain`` even without the clip."""
    name: str
    clip: bool = False
    inject: bool = False
    weight_decay: float = 0.0
    labels: Optional[Tuple[str, ...]] = None


# optax's moment names -> torch's, per optimizer
_MOMENTS = {"adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
            "adadelta": (("e_g", "square_avg"), ("e_x", "acc_delta"))}
_MOMENTS["adamw"] = _MOMENTS["adam"]
# a parameter's route into the optax tree: (flax path, forward layout
# transform, its inverse) (``utils/convert.py::param_routes``)
Route = Tuple[str, Callable, Callable]


def _seq(*states) -> Dict:
    """A tuple of optax states as flax's state dict gives it."""
    return {str(i): st for i, st in enumerate(states)}


def _leaf(tree: Dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _jax_label(top: str) -> str:
    """``dual_opt.build_dual_optimizer``'s label of a top-level params key."""
    return "encoder" if top == "encoder" else "decoder"


class ScheduledOptimizer:
    """A torch optimizer whose groups each carry a learning-rate schedule
    (and, for Adam, an optional beta1 schedule), clipped per group by
    global norm as optax's ``clip_by_global_norm``.

    ``state_dict`` gives the reference checkpoint's ``optimizer`` (the
    torch optimizer's state dict) and ``scheduler`` (the update count the
    schedules read) entries; ``optax_state`` and ``load_optax_state`` the
    JAX trainer's ``opt_state`` in the optimizer's ``layout``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: Sequence[Schedule],
                 b1_schedules: Optional[Sequence[Optional[Schedule]]] = None,
                 max_grad_norm: Optional[float] = None,
                 layout: Optional[OptaxLayout] = None):
        if len(schedules) != len(optimizer.param_groups):
            raise ValueError("one schedule per parameter group")
        self.optimizer = optimizer
        self.schedules = list(schedules)
        self.b1_schedules = list(b1_schedules or [None] * len(schedules))
        self.max_grad_norm = max_grad_norm
        self.layout = layout
        self.count = 0  # updates made so far

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def lr(self, group: int = 0) -> float:
        """Group ``group``'s learning rate for the next update."""
        return self.schedules[group](self.count)

    def step(self) -> torch.Tensor:
        """Clip, set each group's hyperparameters, update -> the global norm
        of the gradients before clipping (f32 scalar tensor)."""
        sq_norms = []
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # optax updates every leaf, with a zero grad
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in group["params"]]
            norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
            sq_norms.append(norm.square())
            if self.max_grad_norm is not None:
                # optax: select(norm < max, g, (g / norm) * max)
                keep = norm < self.max_grad_norm
                one = torch.ones_like(norm)
                torch._foreach_div_(grads, torch.where(keep, one, norm))
                torch._foreach_mul_(grads, torch.where(
                    keep, one, torch.full_like(norm, self.max_grad_norm)))
        for group, schedule, b1 in zip(self.optimizer.param_groups,
                                       self.schedules, self.b1_schedules):
            group["lr"] = schedule(self.count)
            if b1 is not None:
                group["betas"] = (b1(self.count), group["betas"][1])
        self.optimizer.step()
        self.count += 1
        return torch.stack(sq_norms).sum().sqrt()

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": {"step": self.count}}

    def load_state_dict(self, optimizer_state, scheduler_state) -> None:
        self.optimizer.load_state_dict(optimizer_state)
        self.count = int(scheduler_state["step"])

    def _layout(self) -> OptaxLayout:
        if self.layout is None:
            raise ValueError("this optimizer has no optax layout")
        return self.layout

    def _group_labels(self, routes: Dict[torch.Tensor, Route]):
        """Each group's label (None for one chain), checked against the JAX
        trainer's routing of every parameter."""
        labels = self._layout().labels
        if labels is None:
            return [None]
        for label, group in zip(labels, self.optimizer.param_groups):
            for p in group["params"]:
                if _jax_label(routes[p][0].split("/")[0]) != label:
                    raise ValueError(f"{routes[p][0]} is not in the JAX "
                                     f"trainer's {label} group")
        return list(labels)

    def optax_state(self, routes: Dict[torch.Tensor, Route]) -> Dict:
        """The optax ``opt_state`` of this optimizer, as flax's
        ``to_state_dict(optimizer.init(params))`` lays it out, numpy leaves:
        each parameter's moments at its flax path in flax's layout, the
        Adam count from torch's per-parameter ``step``, every schedule count
        from ``count``. ``routes``: each parameter's route."""
        layout = self._layout()
        labels = self._group_labels(routes)
        tops = sorted({path.split("/")[0] for path, _, _ in routes.values()})
        states = {}
        for index, (label, group) in enumerate(zip(labels, self.optimizer.param_groups)):
            moments = {name: {} for name, _ in _MOMENTS[layout.name]}
            steps = set()
            for p in group["params"]:
                path, forward, _ = routes[p]
                st = self.optimizer.state.get(p, {})
                steps.add(int(st["step"]) if "step" in st else 0)
                for name, torch_name in _MOMENTS[layout.name]:
                    value = (st[torch_name].detach().float().cpu().numpy() if st
                             else np.zeros(tuple(p.shape), np.float32))
                    _set_path(moments[name], path, forward(value))
            if len(steps) > 1:
                raise ValueError(f"the parameters' update counts differ: {sorted(steps)}")
            if label is not None:  # multi_transform masks the other group's subtrees
                moments = {name: {top: (tree.get(top, {}) if _jax_label(top) == label
                                        else {}) for top in tops}
                           for name, tree in moments.items()}
            states[label] = self._chain_state(index, moments, steps.pop() if steps else 0)
        if labels == [None]:
            return states[None]
        return {"inner_states": {label: {"inner_state": states[label]}
                                 for label in labels}}

    def _chain_state(self, index: int, moments: Dict, step: int) -> Dict:
        """Parameter group ``index``'s chain, its moments and Adam count
        given."""
        layout = self._layout()
        count = np.asarray(self.count, np.int32)
        if layout.name == "adadelta":
            core = _seq({}, moments, {"count": count})
        else:
            adam = {"count": np.asarray(step, np.int32), **moments}
            tail = ({},) if layout.name == "adamw" else ()
            if layout.inject:
                # the hyperparameters of the last update (the schedules at the
                # count before it), or of init
                at = max(self.count - 1, 0)
                group = self.optimizer.param_groups[index]
                hyper = {"learning_rate": self.schedules[index](at),
                         "b1": self.b1_schedules[index](at),
                         "b2": group["betas"][1], "eps": group["eps"], "eps_root": 0.0}
                if layout.name == "adamw":
                    hyper["weight_decay"] = layout.weight_decay
                core = {"count": count,
                        "hyperparams": {k: np.asarray(v, np.float32)
                                        for k, v in hyper.items()},
                        "hyperparams_states": {"b1": {"count": count},
                                               "learning_rate": {"count": count}},
                        "inner_state": _seq(adam, *tail, {})}
            else:
                core = _seq(adam, *tail, {"count": count})
        if layout.clip:
            return _seq({}, core)
        return _seq(core) if layout.labels is not None else core

    def load_optax_state(self, opt_state: Dict, routes: Dict[torch.Tensor, Route]) -> None:
        """Restore an optax ``opt_state`` (numpy leaves, this optimizer's
        layout) into the torch optimizer: the moments through each
        parameter's inverse layout transform, torch's ``step`` from the Adam
        count (Adadelta: the schedule's), ``count`` from the schedules'."""
        layout = self._layout()
        labels = self._group_labels(routes)
        torch_state = self.optimizer.state_dict()
        counts = set()
        for label, group, indices in zip(labels, self.optimizer.param_groups,
                                         (g["params"] for g in torch_state["param_groups"])):
            tree = (opt_state if label is None
                    else opt_state["inner_states"][label]["inner_state"])
            if layout.clip:
                tree = tree["1"]
            elif layout.labels is not None:
                tree = tree["0"]
            if layout.name == "adadelta":
                moments, count = tree["1"], int(tree["2"]["count"])
                step = count
            elif layout.inject:
                moments, count = tree["inner_state"]["0"], int(tree["count"])
                step = int(moments["count"])
            else:
                moments, step = tree["0"], int(tree["0"]["count"])
                count = int(tree[str(len(tree) - 1)]["count"])
            counts.add(count)
            for p, index in zip(group["params"], indices):
                path, _, inverse = routes[p]
                st = {"step": torch.tensor(float(step))}
                for name, torch_name in _MOMENTS[layout.name]:
                    # a copy: the file's leaves may be read-only views of its bytes
                    st[torch_name] = torch.from_numpy(np.array(
                        inverse(np.asarray(_leaf(moments[name], path))), np.float32))
                torch_state["state"][index] = st
        if len(counts) > 1:
            raise ValueError(f"the groups' schedule counts differ: {sorted(counts)}")
        self.optimizer.load_state_dict(torch_state)
        self.count = counts.pop()


def build_optimizer(name: str, params, schedule: Schedule, *,
                    weight_decay: float = 0.0,
                    max_grad_norm: Optional[float] = None,
                    b1_schedule: Optional[Schedule] = None) -> ScheduledOptimizer:
    """Adam (no weight decay, as the reference's), AdamW (decoupled decay)
    or Adadelta (decay added to the gradient before the update, where
    optax's ``add_decayed_weights`` adds it and where ``torch.optim.
    Adadelta`` does) over one parameter group. ``b1_schedule`` rewrites
    Adam's beta1 every step (circular momentum); Adadelta has no betas and
    ignores it, as the JAX package does."""
    params = list(params)
    name = name.lower()
    layout = OptaxLayout(name, clip=max_grad_norm is not None,
                         inject=b1_schedule is not None and name != "adadelta",
                         weight_decay=weight_decay)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "adadelta":
        opt = torch.optim.Adadelta(params, lr=0.0, rho=0.9, eps=1e-6,
                                   weight_decay=weight_decay)
        b1_schedule = None
    else:
        raise NotImplementedError(f"optimizer {name}")
    return ScheduledOptimizer(opt, [schedule], [b1_schedule], max_grad_norm, layout)


def make_train_step(model, optimizer: ScheduledOptimizer, pad_id: int, *,
                    compute_dtype: torch.dtype = torch.float32) -> Callable:
    """-> ``train_step(images, text, teacher_forced)`` -> (metrics
    {"loss", "grad_norm"} as f32 scalar tensors, argmax sequences
    [B, L-1]). ``images`` [B, H, W, C] standardized; ``text`` [B, L]
    ``<SOS> ... <EOS> <PAD>*``; the model's parameters and BatchNorm
    statistics are updated in place."""

    def train_step(images: torch.Tensor, text: torch.Tensor,
                   teacher_forced: bool = True):
        model.train()
        with autocast(images.device, compute_dtype):
            if teacher_forced:
                logits = teacher_forced_logits(model, images, text[:, :-1])
            else:
                logits = ar_sampled_logits(model, images, text.shape[1] - 1)
        loss = cross_entropy_ignore_pad(logits, text[:, 1:], pad_id)
        optimizer.zero_grad()
        loss.backward()
        grad_norm = optimizer.step()
        sequences = logits.detach().argmax(dim=-1)
        return {"loss": loss.detach(), "grad_norm": grad_norm}, sequences

    return train_step


def cast_fast(fast, dtype: torch.dtype):
    """A fused decoder (``FastDecoder`` or ``FastAster``) with its weights in
    ``dtype`` (validation in the compute type)."""
    if isinstance(fast, FastAster):
        tensors = {k: v.to(dtype) for k, v in fast._asdict().items() if torch.is_tensor(v)}
        return fast._replace(**tensors, cells=tuple(
            FastAsterCell(*(t.to(dtype) for t in cell)) for cell in fast.cells))
    return fast._replace(
        embed_scaled=fast.embed_scaled.to(dtype),
        pos_encoding=fast.pos_encoding.to(dtype),
        layers=tuple(LayerWeights(*(t.to(dtype) for t in layer))
                     for layer in fast.layers),
        w_gen=fast.w_gen.to(dtype), b_gen=fast.b_gen.to(dtype))


@torch.no_grad()
def greedy_logits(model, fast, images: torch.Tensor, steps: int, *,
                  plain: bool = False, compute_dtype: torch.dtype = torch.float32,
                  picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy over ``steps`` steps without the manager, from standardized
    ``images`` [B, H, W, C] -> logits [B, steps, V] f32. The encoder runs
    under ``compute_dtype``'s autocast; ``fast`` is the model's fused
    decoder (a ``FastDecoder``: kernel 3 per layer; a ``FastAster``: the
    fused LSTM step), in the type the decode runs in. The model must be in
    eval mode. ``picks`` [B, >= steps - 1] replays another run's argmax
    picks in place of this run's."""
    with autocast(images.device, compute_dtype):
        src = model.encode(images, plain=plain)
    if isinstance(fast, FastAster):
        step = aster_step(fast, src.to(fast.w_gen.dtype))
    else:
        cross_kv, cache = decode_buffers(fast, src, steps)

        def step(token, t):
            return fast_decode_step(fast, token, t, cross_kv, cache, plain=plain)
    token = torch.full((images.shape[0],), model.sos_id, dtype=torch.int64,
                       device=images.device)
    logits = []
    for t in range(steps):
        step_logits = step(token, t)
        logits.append(step_logits)
        token = step_logits.argmax(dim=-1) if picks is None else picks[:, t]
    return torch.stack(logits, dim=1)


def make_eval_step(model, pad_id: int, *, plain: bool = False,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """-> ``eval_step(images, text)`` -> (loss, sequences [B, L-1], logits
    [B, L-1, V] f32): ``greedy_logits`` over ``L - 1`` steps in eval mode,
    and the CE of its logits.

    The fused decoder weights are read here, once: make the step again
    after the parameters change (the trainer does, at every validation).
    The encoder's kernel-2 operands re-fold by themselves
    (``MBConv.folded``)."""
    fast = cast_fast(build_fast(model), compute_dtype)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, text: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            logits = greedy_logits(model, fast, images, text.shape[1] - 1,
                                   plain=plain, compute_dtype=compute_dtype)
        finally:
            model.train(was_training)
        loss = cross_entropy_ignore_pad(logits, text[:, 1:], pad_id)
        return loss, logits.argmax(dim=-1), logits

    return eval_step
