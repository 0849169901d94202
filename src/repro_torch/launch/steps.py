"""Train, eval and serving steps of the LM.

Counterpart of ``repro.launch.steps``'s ``make_train_step``,
``make_eval_step``, ``make_prefill_step`` and ``make_serve_step``.  A step
is made for a device (``cuda`` unless the caller asks for ``cpu``; without
a card ``cuda`` raises), takes the port's model
(``repro_torch.models.lm.LM``) on that device, and moves its batch there.
Eval, prefill and decode run under ``torch.inference_mode()``.  A train
step is the loss, ``backward()``, then AdamW, which updates the model's
parameters and the moments in place; it runs with PyTorch's deterministic
algorithms, so that a run resumed from a checkpoint repeats the
uninterrupted one bit for bit (on CUDA the embedding gather's backward, a
scatter-add, is otherwise nondeterministic).  An op without a
deterministic version raises; so does every cuBLAS product on CUDA unless
``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) was set before the process first
used cuBLAS, as ``repro_torch.launch.train.main`` sets it.

A batch's ``inputs`` are token ids [B, S], or embeddings [B, S, d] when
``cfg.embed_inputs`` is False (HuBERT behind its frontend stub), as
:func:`batch_specs` gives them; another rank raises.

The serving steps and the train step take ``mesh=`` (a ``RankMesh``, or
a ``launch.mesh.MetaMesh`` on ``meta``): the model is then that rank's
shards (``lm.init_params(..., mesh=)``, ``transfer.params_from_numpy(...,
mesh=)``), the inputs come whole to every rank and the step runs the
rank's rows of them under the ambient mesh (``models.meshctx``).  The
serving steps return the whole logits on every rank.  The train step
takes the vocab-parallel loss and its backward through the collectives'
adjoints (``lm.lm_loss``), sums each leaf's gradient over the batch's
axes it is not split over (``models.shard.Layout.grad_axes``) with
``mesh.psum`` (float32 adds in rank order, so that a run on nccl can be
held bit for bit against gloo), and runs AdamW on the rank's shards with
the global norm summed over the mesh.

The input specs (:func:`batch_specs`, :func:`decode_specs`,
:func:`opt_specs`, :func:`input_specs`) are the reference's
``ShapeDtypeStruct`` stand-ins: tensors on ``meta`` (the
default) with the shapes and dtypes of a cell's inputs, which hold no
memory and which every step takes, so that ``launch.dryrun`` runs a step
without allocating.  On another device they hold values: weights drawn
as ``lm.init_params`` draws them, ids and embeddings drawn, masks all
on, caches and moments zero.  Two differences from the reference's
structs: the weights are the port's model (``lm.LM``, flat names) and the
caches its dict; the xLSTM cells' states are float32 (the reference's
spec says the compute dtype, and its carries are float32 after the first
step).  With ``mesh=`` the parameters and caches are the mesh's own
rank's, the batch and the tokens whole, as the steps take them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import lm, meshctx, shard
from repro_torch.models.collectives import tally, tally_since
from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.optim import AdamWConfig, adamw_update

def _on(params: lm.LM, dev: torch.device, what: str) -> None:
    if params.device.type != dev.type:
        raise ValueError(f"{what} was made for {dev}, but the model lies on "
                         f"{params.device}")


def _inputs(cfg: ModelConfig, inputs, dev: torch.device) -> torch.Tensor:
    """A batch's inputs on ``dev``: ids [B, S], or [B, S, d] embeddings
    when the config takes them embedded."""
    x = torch.as_tensor(inputs, device=dev)
    if cfg.embed_inputs:
        ok, what = x.ndim == 2, "token ids [B, S]"
    else:
        ok = x.ndim == 3 and x.shape[-1] == cfg.d_model
        what = f"embeddings [B, S, {cfg.d_model}]"
    if not ok:
        raise ValueError(f"{cfg.name} takes {what} as inputs, got "
                         f"{tuple(x.shape)}")
    return x


def _check_mesh(params: lm.LM, mesh, kind: str) -> None:
    """A model and a step agree on the mesh: both without one, or the
    model cut for this mesh's rank."""
    layout = params.layout
    if mesh is None and layout is not None:
        raise ValueError(f"{kind} was made without a mesh, but the model "
                         f"holds a rank's shards: make it with mesh=")
    if mesh is not None and (layout is None or not layout.matches(mesh)):
        raise ValueError(f"{kind} was made for {mesh!r}, but the model "
                         f"was not cut for that rank (lm.init_params or "
                         f"params_from_numpy with mesh=)")


def make_serve_step(cfg: ModelConfig, device="cuda", mesh=None):
    """serve_step(params, caches, tokens [B, 1]) -> (logits [B, V] float32
    with the logit softcap, caches updated in place).  ``mesh``: the
    rank's model and caches, every rank the whole tokens and logits."""
    dev = resolve_device(device)
    if mesh is not None:
        shard.check_supported(cfg)

    def serve_step(params: lm.LM, caches: Dict[str, Any], tokens):
        _on(params, dev, "serve_step")
        _check_mesh(params, mesh, "serve_step")
        tokens = torch.as_tensor(tokens, device=dev)
        with torch.inference_mode(), meshctx.using(mesh):
            return lm.serve_step(cfg, params, caches, tokens)
    return serve_step


def make_prefill_step(cfg: ModelConfig, device="cuda", mesh=None):
    """prefill_step(params, {"inputs": [B, S] ids or [B, S, d]
    embeddings}) -> last-token logits [B, 1, V] in the compute dtype,
    without the logit softcap (as the reference).  Every attention layer
    runs the flash kernel.  ``mesh``: the rank's model runs its rows of
    the inputs, and every rank returns the whole logits (``lm.prefill``)."""
    dev = resolve_device(device)
    if mesh is not None:
        shard.check_supported(cfg)

    def prefill_step(params: lm.LM, batch: Dict[str, Any]):
        _on(params, dev, "prefill_step")
        _check_mesh(params, mesh, "prefill_step")
        inputs = _inputs(cfg, batch["inputs"], dev)
        with torch.inference_mode(), meshctx.using(mesh):
            return lm.prefill(cfg, params, inputs)
    return prefill_step


def _batch_on(cfg: ModelConfig, batch: Dict[str, Any], dev: torch.device):
    return {k: _inputs(cfg, v, dev) if k == "inputs"
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block (restored after);
    an op that has none raises."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def reduce_grads(layout: shard.Layout, mesh, grads: Dict[str, Any],
                 rows) -> Dict[str, Any]:
    """Each gradient summed over its ``layout.grad_axes`` (the batch split
    over ``rows``) with ``mesh.psum``: the leaves of one axis set and dtype
    flattened into one buffer, one ``psum`` a buffer.  The sum is
    elementwise, so the flattening does not change its bits.  Returns the
    new gradients by name."""
    plan = lm.plan_model(layout.cfg)
    groups: Dict[tuple, list] = {}
    for name, g in grads.items():
        axes = layout.grad_axes(plan[name], rows)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(name)
    out = dict(grads)
    for (axes, _), names in groups.items():
        flat = mesh.psum(torch.cat([grads[n].reshape(-1) for n in names]),
                         axes)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            out[n] = part.view(grads[n].shape)
    return out


class _Phases:
    """What ``mesh`` counts (``models.collectives.tally``) between one
    call and the next, by the name given at the later; nothing without a
    mesh."""

    def __init__(self, mesh):
        self.mesh, self.comm, self.seen = mesh, {}, None
        self("")

    def __call__(self, name: str) -> None:
        if self.mesh is None:
            return
        if self.seen is not None and name:
            self.comm[name] = tally_since(self.mesh, self.seen)
        self.seen = tally(self.mesh)


def value_and_grad(cfg: ModelConfig, params: lm.LM, batch: Dict[str, Any],
                   mesh=None, phases: Optional[_Phases] = None):
    """``(loss, grads)``: the loss of ``batch`` (detached) and each
    parameter's gradient by name (zeros where none reached it), with
    PyTorch's deterministic algorithms; ``mesh``: the model's rank's, run
    under that mesh, each gradient summed over its batch axes
    (:func:`reduce_grads`), so that it is the whole batch's gradient of the
    rank's shard.  The model's ``.grad`` are left None."""
    named = dict(params.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"train_step needs a model built with "
                         f"trainable=True; {frozen[:4]} take no gradients")
    phases = phases or _Phases(None)
    with deterministic(), meshctx.using(mesh):
        batch = _batch_on(cfg, batch, params.device)
        loss = lm.lm_loss(cfg, params, batch)
        phases("forward")
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        phases("backward")
        if mesh is not None:
            rows = params.layout.rows(batch["inputs"].shape[0])[1]
            grads = reduce_grads(params.layout, mesh, grads, rows)
        phases("grads")
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    device="cuda", mesh=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): ``params`` an ``LM`` built with
    ``trainable=True``, updated in place with its moments (the returned
    ``params`` is the same model); the metrics are float32 scalars on the
    device.  ``mesh``: the model and moments are the mesh's rank's shards
    and the batch comes whole; the loss is the whole batch's, every rank
    the same, and the metrics also hold ``comm``, what the mesh counted
    (``models.collectives.tally``: a ``RankMesh``'s seconds and calls, a
    ``MetaMesh``'s bytes) in each phase of the step: ``forward``,
    ``backward`` (the remat recompute's collectives among them),
    ``grads`` (:func:`reduce_grads`) and ``update`` (AdamW's norm)."""
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)
    if mesh is not None:
        shard.check_supported(cfg)

    def train_step(params: lm.LM, opt_state, batch: Dict[str, Any]):
        _on(params, dev, "train_step")
        _check_mesh(params, mesh, "train_step")
        phases = _Phases(mesh)
        loss, grads = value_and_grad(cfg, params, batch, mesh, phases)
        named = dict(params.named_parameters())
        norm_axes = None
        if mesh is not None:
            plan = lm.plan_model(cfg)
            norm_axes = {n: params.layout.split_axes(plan[n]) for n in named}
        with deterministic():
            _, opt_state, info = adamw_update(grads, opt_state, named,
                                              opt_cfg, mesh, norm_axes)
        phases("update")
        metrics = {"loss": loss, **info}
        if mesh is not None:
            metrics["comm"] = phases.comm
        return params, opt_state, metrics
    return train_step


def make_eval_step(cfg: ModelConfig, device="cuda"):
    """eval_step(params, batch) -> the loss, a float32 scalar."""
    dev = resolve_device(device)

    def eval_step(params: lm.LM, batch: Dict[str, Any]):
        _on(params, dev, "eval_step")
        with torch.inference_mode():
            return lm.lm_loss(cfg, params, _batch_on(cfg, batch, dev))
    return eval_step


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def _draw(dev: torch.device, generator):
    """``generator`` where values are drawn (a fresh one seeded 0 on
    ``dev`` when None); None on ``meta``, where nothing is drawn."""
    if dev.type == "meta":
        return None
    return generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)


def _ids(shape, vocab: int, dev: torch.device, gen) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return torch.randint(0, vocab, shape, generator=gen, device=gen.device,
                         dtype=torch.int32).to(dev)


def batch_specs(cfg: ModelConfig, cell: ShapeCell, device="meta",
                generator=None) -> Dict[str, torch.Tensor]:
    """A train or prefill batch: ``inputs`` int32 ids [B, S] (or [B, S, d]
    embeddings in the compute dtype when ``cfg.embed_inputs`` is False),
    ``targets`` int32 [B, S] and a bool ``mask`` [B, S]."""
    dev = resolve_device(device)
    gen = _draw(dev, generator)
    b, s = cell.global_batch, cell.seq_len
    if cfg.embed_inputs:
        inputs = _ids((b, s), cfg.vocab, dev, gen)
    elif gen is None:
        inputs = torch.empty((b, s, cfg.d_model), dtype=cfg.dtype("compute"),
                             device=dev)
    else:
        inputs = torch.randn((b, s, cfg.d_model), generator=gen,
                             device=gen.device).to(dev, cfg.dtype("compute"))
    return {"inputs": inputs, "targets": _ids((b, s), cfg.vocab, dev, gen),
            "mask": torch.ones((b, s), dtype=torch.bool, device=dev)}


def decode_specs(cfg: ModelConfig, cell: ShapeCell, device="meta",
                 generator=None, mesh=None):
    """(tokens int32 [B, 1], caches of ``cell.seq_len`` positions as
    ``lm.init_caches`` makes them, ``mesh``'s rank's under a mesh) for one
    serve step."""
    dev = resolve_device(device)
    tokens = _ids((cell.global_batch, 1), cfg.vocab, dev,
                  _draw(dev, generator))
    return tokens, lm.init_caches(cfg, cell.global_batch, cell.seq_len,
                                  device=dev, mesh=mesh)


def opt_specs(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
              device="meta", mesh=None) -> Dict[str, Any]:
    """AdamW's state for ``cfg``'s parameters: ``m`` and ``v`` by
    parameter name in ``opt_cfg.opt_dtype`` (zero), and an int32
    ``step``, as ``optim.adamw_init`` makes it; ``mesh``: at the shapes of
    the mesh's rank's shards."""
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)
    plan = lm.plan_model(cfg) if mesh is None \
        else shard.Layout.of(cfg, mesh).plan()

    def moments():
        return {n: torch.zeros(s.shape, dtype=opt_cfg.opt_dtype, device=dev)
                for n, s in plan.items()}
    return {"m": moments(), "v": moments(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                opt_cfg: Optional[AdamWConfig] = None, device="meta",
                generator=None, mesh=None):
    """Everything one step of ``cell`` takes: ``(step_fn, args)``, the
    step made for ``device`` and its arguments there: ``(params,
    opt_state, batch)`` for a train cell (the model built with
    ``trainable=True``), ``(params, batch)`` for a prefill, ``(params,
    caches, tokens)`` for a decode cell.  ``mesh``: the step and the
    arguments of ``mesh``'s own rank (the parameters, moments and caches
    its shards, the batch and tokens whole; rules that split the
    sequence or ``d_model`` raise, ``models.shard.check_supported``)."""
    dev = resolve_device(device)
    if mesh is not None:
        shard.check_supported(cfg)
    gen = _draw(dev, generator)
    params = lm.init_params(cfg, gen, dev, trainable=cell.kind == "train",
                            mesh=mesh)
    if cell.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        return make_train_step(cfg, opt_cfg, dev, mesh), (
            params, opt_specs(cfg, opt_cfg, dev, mesh),
            batch_specs(cfg, cell, dev, gen))
    if cell.kind == "prefill":
        return make_prefill_step(cfg, dev, mesh), (
            params, batch_specs(cfg, cell, dev, gen))
    tokens, caches = decode_specs(cfg, cell, dev, gen, mesh)
    return make_serve_step(cfg, dev, mesh), (params, caches, tokens)
