"""Carry state across from the JAX package's objects.

BC has no weights: the state both packages must share is the graph and
the round schedule.  These functions take the *numpy fields* of the JAX
package's ``Graph`` and ``Round`` objects (so this module imports nothing
of that package) and give the port's equivalents:

    g = graph_from_arrays(jg.n, jg.src, jg.dst, jg.w)
    sched = schedule_from_arrays(
        [(r.sources, r.derived) for r in js.rounds], js.batch_size,
        js.derived_per_round, ...)

    part = partition_from_arrays(jp.R, jp.C, jp.n, jp.chunk, jp.src_local,
                                 jp.dst_local, jp.arc_counts, jp.arc_perm)

With these, one schedule can be fed through both packages'
``traversal_round`` round by round, and one 2-D partition through both
packages' distributed operators.

DLRM has weights: :func:`dlrm_params_from_arrays` takes the JAX package's
parameter dict as numpy arrays and gives the port's module state::

    model.load_state_dict(dlrm_params_from_arrays(
        {k: np.asarray(v) for k, v in jax_params.items()}))

and :func:`dlrm_params_to_jax` goes the other way: the JAX package's
dict (its keys, its [in, out] weights) as views of the port's
parameters.  A train state carries the optimizer's too:
:func:`optimizer_state_to_jax` gives the reference's ``AdamWState`` /
``AdafactorState`` / ``SGDState`` fields (``step``, then ``mu`` / ``nu``,
``vr`` / ``vc`` or ``momentum`` keyed like the parameters) as views of
the port optimizer's state, :func:`optimizer_state_from_jax` copies such
a tree in, and :func:`assign_jax_layout` copies any tree of values into
a tree of such views.  The views are what a checkpoint of the port's
train state holds, so that either package restores the other's.

The LM's parameters: :func:`lm_params_from_jax` takes the JAX package's
tree (``embed``, ``ln_f``, ``layers`` of leaves stacked on a leading L
axis; numpy arrays, bf16 ones of ml_dtypes' ``bfloat16``) and gives the
state dict of :class:`~repro_torch.models.TransformerLM` (stacked keys
``layers.{name}``: the model keeps the reference's layout), bit for bit::

    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray, params)))

and :func:`lm_params_to_jax` gives a model's parameters in that tree (the
parameters themselves, no copy; a bf16 one reads as numpy through
``.view(torch.int16)``).  :func:`lm_optimizer_state_to_jax` /
:func:`lm_optimizer_state_from_jax` do for an LM optimizer's state what
the DLRM functions do, keyed like that tree.

The GNN's parameters: :func:`gnn_params_from_jax` takes the JAX package's
GNN tree (``enc_w``, ``dec_b``, …, ``layers`` of leaves stacked on L) and
gives the port's flat dict (``models/gnn.py``: the same leaves under
dotted names, ``layers.w1``), bit for bit; :func:`gnn_params_to_jax`
nests a flat dict back into that tree (the tensors themselves, no copy).
:func:`gnn_optimizer_state_to_jax` / :func:`gnn_optimizer_state_from_jax`
carry an optimizer's state of those parameters in the reference's
layout, built from the same pieces as the DLRM and LM ones.
"""
from __future__ import annotations

import re
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from .core.scheduler import Round, Schedule
from .graphs.graph import Graph
from .graphs.partition import TwoDPartition
from .models.transformer import param_specs
from .optim.optimizers import Adafactor, AdamW, SGDMomentum

__all__ = [
    "graph_from_arrays",
    "schedule_from_arrays",
    "partition_from_arrays",
    "dlrm_params_from_arrays",
    "dlrm_params_to_jax",
    "optimizer_state_to_jax",
    "optimizer_state_from_jax",
    "assign_jax_layout",
    "lm_params_from_jax",
    "lm_params_to_jax",
    "lm_optimizer_state_to_jax",
    "lm_optimizer_state_from_jax",
    "gnn_params_from_jax",
    "gnn_params_to_jax",
    "gnn_optimizer_state_to_jax",
    "gnn_optimizer_state_from_jax",
]


def graph_from_arrays(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray | None = None
) -> Graph:
    """The port's :class:`Graph` from a symmetric, (src, dst)-sorted arc list."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be equal 1-D arrays, got {src.shape}, {dst.shape}")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n):
        raise ValueError(f"arc endpoint out of range for n = {n}")
    if w is not None:
        w = np.asarray(w, np.float32)
        if w.shape != src.shape:
            raise ValueError(f"w must align with the arcs, got {w.shape}")
    return Graph(n=int(n), src=src, dst=dst, w=w)


def schedule_from_arrays(
    rounds: Sequence[tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    derived_per_round: int,
    *,
    num_leaf_skipped: int = 0,
    num_isolated_omega: int = 0,
    analytic_corrections: np.ndarray | None = None,
    round_depths: np.ndarray | None = None,
) -> Schedule:
    """The port's :class:`Schedule` from ``(sources i32 [s], derived i32
    [k, 3])`` pairs, one per round; the explicit/derived counts are
    recomputed from the rounds."""
    port_rounds = []
    for sources, derived in rounds:
        sources = np.asarray(sources, np.int32)
        derived = np.asarray(derived, np.int32).reshape(-1, 3)
        if sources.shape != (batch_size,) or derived.shape != (derived_per_round, 3):
            raise ValueError(
                f"round shapes {sources.shape}, {derived.shape} do not match "
                f"batch_size={batch_size}, derived_per_round={derived_per_round}"
            )
        port_rounds.append(Round(sources=sources, derived=derived))
    return Schedule(
        rounds=port_rounds,
        batch_size=int(batch_size),
        derived_per_round=int(derived_per_round),
        num_explicit=sum(int((r.sources >= 0).sum()) for r in port_rounds),
        num_derived=sum(int((r.derived[:, 0] >= 0).sum()) for r in port_rounds),
        num_leaf_skipped=int(num_leaf_skipped),
        num_isolated_omega=int(num_isolated_omega),
        analytic_corrections=(
            np.zeros((0, 2), np.float64)
            if analytic_corrections is None
            else np.asarray(analytic_corrections, np.float64).reshape(-1, 2)
        ),
        round_depths=None if round_depths is None else np.asarray(round_depths, np.int64),
    )


def partition_from_arrays(
    R: int,
    C: int,
    n: int,
    chunk: int,
    src_local: np.ndarray,
    dst_local: np.ndarray,
    arc_counts: np.ndarray,
    arc_perm: np.ndarray | None = None,
) -> TwoDPartition:
    """The port's :class:`TwoDPartition` from the numpy fields of the JAX
    package's one (same layout: ``[R, C, max_arcs]`` local arc indices,
    sentinel destination ``C·chunk``)."""
    src_local = np.asarray(src_local, np.int32)
    dst_local = np.asarray(dst_local, np.int32)
    if src_local.shape != dst_local.shape or src_local.shape[:2] != (R, C):
        raise ValueError(
            f"arc arrays must be [{R}, {C}, max_arcs], got {src_local.shape}, {dst_local.shape}"
        )
    if chunk * R * C < n:
        raise ValueError(f"chunk {chunk} on a {R}x{C} grid cannot hold n = {n}")
    return TwoDPartition(
        R=int(R),
        C=int(C),
        n=int(n),
        chunk=int(chunk),
        src_local=src_local,
        dst_local=dst_local,
        arc_counts=np.asarray(arc_counts, np.int64),
        arc_perm=None if arc_perm is None else np.asarray(arc_perm, np.int64),
    )


_MLP_KEY = re.compile(r"(bot|top)_([wb])(\d+)")


def dlrm_params_from_arrays(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The port's :class:`~repro_torch.models.DLRM` state (CPU tensors) from
    the JAX package's DLRM parameters: ``tables`` [F, V, D] and
    ``{bot,top}_{w,b}{i}``.  JAX stores each weight as [in, out] for
    ``x @ W``; ``nn.Linear`` holds [out, in], so weights are transposed."""
    state = {}
    for key, value in params.items():
        arr = np.asarray(value, np.float32)
        if key == "tables":
            if arr.ndim != 3:
                raise ValueError(f"tables must be [F, V, D], got {arr.shape}")
            state["tables"] = torch.tensor(arr)
            continue
        match = _MLP_KEY.fullmatch(key)
        if match is None:
            raise ValueError(f"unknown DLRM parameter {key!r}")
        tag, kind, i = match.groups()
        if kind == "w":
            if arr.ndim != 2:
                raise ValueError(f"{key} must be [in, out], got {arr.shape}")
            state[f"{tag}.{i}.weight"] = torch.tensor(arr.T)
        else:
            state[f"{tag}.{i}.bias"] = torch.tensor(arr)
    return state


_PORT_MLP_KEY = re.compile(r"(bot|top)\.(\d+)\.(weight|bias)")


def _jax_key(name: str) -> tuple[str, bool]:
    """(the JAX package's key of the port's DLRM parameter ``name``,
    whether the port holds it transposed)."""
    if name == "tables":
        return name, False
    match = _PORT_MLP_KEY.fullmatch(name)
    if match is None:
        raise ValueError(f"unknown DLRM parameter {name!r}")
    tag, i, kind = match.groups()
    return (f"{tag}_w{i}", True) if kind == "weight" else (f"{tag}_b{i}", False)


def dlrm_params_to_jax(named: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The JAX package's DLRM parameter dict from the port's parameters
    (``dict(model.named_parameters())`` or a state dict): ``tables`` and
    ``{bot,top}_{w,b}{i}``, each weight as the [in, out] view ``W.T`` of
    the port's [out, in] one (a view: no copy; ``np.asarray`` of a CPU
    view gives the reference's array)."""
    out = {}
    for name, t in named.items():
        key, transposed = _jax_key(name)
        out[key] = t.T if transposed else t
    return out


#: the reference's optimizer state fields, per port optimizer
_SLOTS = {AdamW: ("mu", "nu"), Adafactor: ("vr", "vc"), SGDMomentum: ("momentum",)}


def _slots(opt) -> tuple[str, ...]:
    if type(opt) not in _SLOTS:
        raise TypeError(f"no JAX layout for the state of {type(opt).__name__}")
    return _SLOTS[type(opt)]


def _one_step(opt, params) -> torch.Tensor:
    """The step every one of ``params`` took (i32 0-d): the reference keeps one."""
    steps = {opt.state[p]["step"] for p in params}
    if len(steps) != 1:
        raise ValueError(f"the parameters took different numbers of steps: {sorted(steps)}")
    return torch.tensor(steps.pop(), dtype=torch.int32)


def optimizer_state_to_jax(opt, named: Mapping[str, torch.Tensor]) -> dict:
    """The reference's optimizer state of the DLRM parameters ``named``
    (port name -> parameter of ``opt``): ``{"step": i32 0-d, <field>:
    {jax key: view}}``.  Elementwise fields of a transposed weight are
    transposed views; Adafactor's ``vr`` / ``vc`` of one are swapped
    (the port's row statistics of [out, in] are the reference's column
    statistics of [in, out]).  Every parameter must have taken the same
    number of steps: the reference keeps one step."""
    slots = _slots(opt)
    tree = {"step": _one_step(opt, named.values())}
    tree.update({slot: {} for slot in slots})
    swap = {"vr": "vc", "vc": "vr"}
    for name, p in named.items():
        key, transposed = _jax_key(name)
        state = opt.state[p]
        for slot in slots:
            if not transposed:
                tree[slot][key] = state[slot]
            elif isinstance(opt, Adafactor):
                tree[slot][key] = state[swap[slot]]
            else:
                tree[slot][key] = state[slot].T
    return tree


def assign_jax_layout(views, values) -> None:
    """Copy ``values`` (numpy arrays or tensors, a nested dict like
    ``views``) into the tensors of ``views`` (views of the port's state,
    as :func:`dlrm_params_to_jax` and :func:`optimizer_state_to_jax` give
    them), in place, shapes checked."""
    if isinstance(views, dict):
        for key, view in views.items():
            assign_jax_layout(view, values[key])
        return
    src = values if isinstance(values, torch.Tensor) else _from_numpy(values)
    if tuple(src.shape) != tuple(views.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(views.shape)}")
    with torch.no_grad():
        views.copy_(src)


def optimizer_state_from_jax(opt, named: Mapping[str, torch.Tensor], tree) -> None:
    """Copy the reference's optimizer state ``tree`` (as
    :func:`optimizer_state_to_jax` lays it out) into ``opt``'s state of
    the parameters ``named``, in place; every parameter takes its
    ``step``."""
    step = int(np.asarray(tree["step"]))
    for p in named.values():
        opt.state[p]["step"] = step
    views = optimizer_state_to_jax(opt, named)
    assign_jax_layout({slot: views[slot] for slot in _slots(opt)},
                      {slot: tree[slot] for slot in _slots(opt)})


def _from_numpy(value) -> torch.Tensor:
    """A CPU tensor holding ``value``'s bits (numpy has no bf16: an
    ml_dtypes ``bfloat16`` array is read through its int16 view); a
    read-only array (as ``np.asarray`` gives of a JAX array) is copied."""
    arr = np.ascontiguousarray(np.asarray(value))
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_jax(cfg, params: Mapping) -> dict[str, torch.Tensor]:
    """The state dict of the port's ``TransformerLM`` for ``cfg`` from the
    JAX package's LM parameter tree (numpy arrays, or anything
    ``np.asarray`` reads): ``embed``, ``ln_f`` and ``layers.{name}``, the
    reference's stacked leaf.  CPU tensors with the
    arrays' bits (sharing a writable array's memory); shapes and dtypes
    are checked against the config."""
    specs = param_specs(cfg)
    flat = [("embed", params["embed"], specs["embed"]), ("ln_f", params["ln_f"], specs["ln_f"])]
    flat += [(f"layers.{name}", params["layers"][name], spec)
             for name, spec in specs["layers"].items()]
    state = {}
    for key, value, (shape, dtype) in flat:
        t = _from_numpy(value)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{key} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        state[key] = t
    return state


def lm_params_to_jax(model) -> dict:
    """The JAX package's LM parameter tree of a ``TransformerLM``:
    ``embed``, ``ln_f`` and ``layers`` (its stacked leaves) — the
    parameters themselves, no copy."""
    return {"embed": model.embed, "ln_f": model.ln_f,
            "layers": dict(model.layers.named_parameters())}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_optimizer_state_to_jax(opt, model) -> dict:
    """The reference's optimizer state of a ``TransformerLM``'s parameters
    (``AdamWState`` / ``AdafactorState`` / ``SGDState`` fields): ``{"step":
    i32 0-d, <field>: tree keyed as :func:`lm_params_to_jax`}``, each leaf
    the port optimizer's own state tensor (no copy; the LM keeps the
    reference's layout, so nothing is transposed or swapped)."""
    params = lm_params_to_jax(model)
    tree = {"step": _one_step(opt, model.parameters())}
    for slot in _slots(opt):
        tree[slot] = _map_tree(lambda p: opt.state[p][slot], params)
    return tree


def lm_optimizer_state_from_jax(opt, model, tree) -> None:
    """Copy the reference's optimizer state ``tree`` of an LM (as
    :func:`lm_optimizer_state_to_jax` lays it out) into ``opt``'s state of
    ``model``'s parameters, in place; every parameter takes its ``step``."""
    step = int(np.asarray(tree["step"]))
    for p in model.parameters():
        opt.state[p]["step"] = step
    views = lm_optimizer_state_to_jax(opt, model)
    assign_jax_layout({slot: views[slot] for slot in _slots(opt)},
                      {slot: tree[slot] for slot in _slots(opt)})


def gnn_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's GNN parameters (``{name: f32 CPU tensor}``, dotted names)
    from the JAX package's GNN tree (numpy arrays, or anything
    ``np.asarray`` reads), bit for bit."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update({f"{key}.{k}": v for k, v in gnn_params_from_jax(value).items()})
            continue
        t = _from_numpy(value)
        if t.dtype != torch.float32:
            raise ValueError(f"{key} must be float32, got {t.dtype}")
        out[key] = t
    return out


def gnn_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The JAX package's GNN tree of a flat ``{dotted name: tensor}`` dict
    (the tensors themselves, no copy)."""
    tree: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def gnn_optimizer_state_to_jax(opt, params: Mapping[str, torch.Tensor]) -> dict:
    """The reference's optimizer state of the GNN parameters ``params``
    (``{"step": i32 0-d, <field>: tree as gnn_params_to_jax}``), each leaf
    the optimizer's own state tensor (the GNN keeps the reference's
    layout: nothing transposed or swapped)."""
    tree = {"step": _one_step(opt, params.values())}
    for slot in _slots(opt):
        tree[slot] = gnn_params_to_jax({k: opt.state[p][slot] for k, p in params.items()})
    return tree


def gnn_optimizer_state_from_jax(opt, params: Mapping[str, torch.Tensor], tree) -> None:
    """Copy the reference's optimizer state ``tree`` of GNN parameters (as
    :func:`gnn_optimizer_state_to_jax` lays it out) into ``opt``, in
    place; every parameter takes its ``step``."""
    step = int(np.asarray(tree["step"]))
    for p in params.values():
        opt.state[p]["step"] = step
    views = gnn_optimizer_state_to_jax(opt, params)
    assign_jax_layout({slot: views[slot] for slot in _slots(opt)},
                      {slot: tree[slot] for slot in _slots(opt)})
