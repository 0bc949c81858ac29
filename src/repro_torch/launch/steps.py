"""Step builders of the LM launchers (port of ``repro/launch/steps.py``):
one FL round, prefill and one decode step, on a mesh or on one device.

Each builder returns ``(fn, arg shapes, in layouts, out layouts)``, as the
JAX builders return ``(fn, arg structs, in shardings, out shardings)``.
The shapes are the WHOLE arguments' (``torch.Size`` leaves, or ``(shape,
dtype)`` for batches); a layout is a tree of specs
(``repro_torch.launch.sharding``).  ``fn`` runs on THIS rank's blocks of
its arguments (:func:`repro_torch.launch.sharding.shard_tree`) and returns
this rank's blocks of its outputs: there is no ``jax.jit`` placing the
pieces.  With ``mesh=None`` the layouts are None and ``fn`` is the
one-device step, op for op what it was before meshes.

On a mesh the transformer is split over ``model``
(:class:`repro_torch.parallel.TensorParallel`) and a round's clients
over ``pod`` / ``data`` (:class:`repro_torch.core.aggregate.
ClientSharding`: each data group trains its clients and the weighted
average is all-reduced over the ranks that hold the same blocks).

The FSDP layout (``client_sequential`` with leaves split over a ``data``
axis of more than one rank: arctic-480b, qwen2-vl-7b, recurrentgemma-9b
on a mesh) runs the JAX semantics of ``client_sequential``: every rank
visits every client in turn from the global model, and the clients'
weighted running sums make the new state; each rank holds only its
blocks of the global state, the client model, its optimizer state, the
gradients and the running sums.  The batch arrives in JAX's layout
(``train_batch_shardings``: the client axis over ``data`` where it
divides), so the round gathers it over the ranks that split it and each
data rank keeps its share of every client's rows (all of them where
``data`` does not divide the client's batch).  A local step gathers the
``data``-split leaves where the model uses them (``parallel.fsdp_gather``;
inside a ``remat="layer"`` cycle, so the backward gathers again; the
token table and the head move the rows' columns and partial logits
instead, ``models/transformer.py``) and sums the gradients over ``data``
(``core/local.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, FLConfig, InputShape
from repro_torch.core.rounds import make_round_fn
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import fl_plan, input_specs
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import make_bundle

__all__ = ["param_struct", "state_struct", "build_train_step",
           "build_prefill_step", "build_serve_step", "build_step",
           "tensor_parallel"]

# the algorithms whose losses a tensor-parallel bundle computes
TP_ALGORITHMS = ("fedavg", "fedmmd", "fedfusion", "fedl2")


def param_struct(cfg: ArchConfig) -> Dict[str, Any]:
    """The transformer's parameter tree with ``torch.Size`` leaves, as
    ``tfm.init_params`` draws it (nothing is allocated): the encoder
    (``enc``), the decoder layers' cross-attention (``lnx`` / ``xattn``)
    and layer-norm biases of the audio family, and the VLM's
    ``vis_proj``, included."""
    from repro_torch.configs.base import RGLRU, SSD
    from repro_torch.models.transformer import cycle_split
    d, hd = cfg.d_model, cfg.head_dim
    c, n_full, rem = cycle_split(cfg.block_pattern)
    cross = cfg.n_enc_layers > 0

    def norm(*lead):            # layer norm (audio) has a bias
        n = {"scale": torch.Size(lead + (d,))}
        if cfg.family == "audio":
            n["bias"] = n["scale"]
        return n

    def attn(S):
        return {"wq": S(d, cfg.n_heads * hd), "wk": S(d, cfg.n_kv_heads * hd),
                "wv": S(d, cfg.n_kv_heads * hd), "wo": S(cfg.n_heads * hd, d)}

    def layer(lead, kind):
        S = lambda *s: torch.Size(lead + s)

        def mlp(*io):           # w1 / w3 [*io], w2 its transpose
            p = {"w1": S(*io), "w2": S(*io[:-2], io[-1], io[-2])}
            if cfg.act == "silu":
                p["w3"] = S(*io)
            return p

        out = {"ln1": norm(*lead)}
        if kind == SSD:
            d_inner = cfg.ssm_expand * d
            H = d_inner // cfg.ssm_head_dim
            conv_ch = d_inner + 2 * cfg.ssm_state
            out["ssd"] = {"w_in": S(d, d_inner + conv_ch + H),
                          "conv_w": S(cfg.ssm_conv_width, conv_ch),
                          "conv_b": S(conv_ch), "A_log": S(H),
                          "dt_bias": S(H), "D": S(H),
                          "w_out": S(d_inner, d)}
            return out
        if kind == RGLRU:       # the JAX block's conv width, 4
            W = cfg.lru_width
            out["rglru"] = {"w_x": S(d, W), "w_gate": S(d, W),
                            "conv_w": S(4, W), "conv_b": S(W), "lam": S(W),
                            "w_a": S(W, W), "b_a": S(W), "w_i": S(W, W),
                            "b_i": S(W), "w_out": S(W, d)}
        else:
            out["attn"] = attn(S)
            if cross and kind != "enc":
                out["lnx"], out["xattn"] = norm(*lead), attn(S)
        out["ln2"] = norm(*lead)
        if cfg.n_experts and kind not in (SSD, RGLRU):
            out["moe"] = {"router": S(d, cfg.n_experts),
                          **mlp(cfg.n_experts, d, cfg.moe_d_ff)}
            if cfg.dense_residual:
                out["moe"]["dense"] = mlp(d, cfg.d_ff)
        else:
            out["ffn"] = mlp(d, cfg.d_ff)
        return out

    params = {"embed": {"table": torch.Size((cfg.vocab_size, d))},
              "final_norm": norm(),
              "cycles": tuple(layer((n_full,), cfg.block_pattern[j])
                              for j in range(c)),
              "tail": tuple(layer((), cfg.block_pattern[n_full * c + j])
                            for j in range(rem))}
    if not cfg.tie_embeddings:
        params["head"] = {"w": torch.Size((d, cfg.vocab_size))}
    if cfg.family == "vlm":
        params["vis_proj"] = {"w": torch.Size((d, d))}
    if cross:
        params["enc"] = {"layers": layer((cfg.n_enc_layers,), "enc"),
                         "norm": norm(), "in_proj": {"w": torch.Size((d, d))}}
    return params


@functools.lru_cache(maxsize=64)
def _extra_shapes(cfg: ArchConfig, fl: FLConfig):
    from repro_torch.core.local import _algorithm
    from repro_torch.tree import tree_map
    extra = _algorithm(fl).init_extra_state(make_bundle(cfg), fl,
                                            torch.Generator())
    return tree_map(lambda t: t.shape, extra)


def state_struct(cfg: ArchConfig, fl: FLConfig) -> Dict[str, Any]:
    """``{"model": param_struct, **extras}``: the global state's shapes
    (the algorithm's extra state is drawn once on the CPU for its shapes,
    and the shapes kept)."""
    return {"model": param_struct(cfg), **_extra_shapes(cfg, fl)}


def tensor_parallel(mesh, specs, cache_specs=None, *, fsdp=False,
                    rows_split=False):
    """The :class:`repro_torch.parallel.TensorParallel` of this rank on
    ``mesh`` for a state with specs ``specs`` (``{"model": ..., **the
    algorithm's extra state}``); ``fsdp`` / ``rows_split`` as there."""
    from repro_torch.launch.mesh import axes_place
    from repro_torch.parallel import ModelParallel, TensorParallel
    return TensorParallel(ModelParallel(functools.partial(axes_place, mesh)),
                          specs, cache_specs, fsdp=fsdp,
                          rows_split=rows_split)


def _fsdp_split(mesh, shapes, specs) -> bool:
    """Whether some leaf of ``shapes`` is split over a ``data`` axis of
    more than one rank under ``specs``."""
    from repro_torch.launch.mesh import axis_size
    if axis_size(mesh, "data") <= 1:
        return False
    found = []
    sh.tree_with_path(lambda path, _: found.append(any(
        "data" in sh.spec_axes(e) for e in sh.spec_at(specs, path))), shapes)
    return any(found)


def build_train_step(cfg: ArchConfig, fl: FLConfig, shape: InputShape,
                     mesh=None, dtype=torch.float32):
    """One FL round (paper Alg. 1/2) of ``cfg``'s bundle in its
    ``fl_mode``.  Returns ``(round_fn, (state, batch, n_examples, lr)
    shapes, in layouts, out layouts)``: ``round_fn(state, batch,
    n_examples, lr) -> (state, {"local_loss"})`` on this rank's blocks
    (the state's, its clients' batch [C_loc, steps, B, S] and n_examples
    [C_loc]), on the state's device."""
    mode = cfg.fl_mode
    state_shapes = state_struct(cfg, fl)
    batch_shapes = input_specs(cfg, shape, mesh)
    plan = fl_plan(cfg, shape, mesh)
    args = (state_shapes, batch_shapes,
            (torch.Size((plan.n_clients,)), torch.float32),
            (torch.Size(()), torch.float32))
    if mesh is None:
        round_fn = make_round_fn(make_bundle(cfg, dtype), fl, mode)
        return round_fn, args, None, None
    if fl.algorithm not in TP_ALGORITHMS:
        raise NotImplementedError(
            f"{fl.algorithm}: a tensor-parallel round runs "
            f"{TP_ALGORITHMS} only")
    fsdp = mode == "client_sequential"
    state_specs = sh.param_shardings(mesh, state_shapes, fsdp=fsdp)
    batch_specs = sh.train_batch_shardings(
        mesh, {k: torch.Size(v[0]) for k, v in batch_shapes.items()})
    nex_spec = sh.train_batch_shardings(mesh, args[2][0])
    in_layouts = (state_specs, batch_specs, nex_spec, ())
    out_layouts = (state_specs, {"local_loss": ()})
    if fsdp and _fsdp_split(mesh, state_shapes, state_specs):
        return (_fsdp_round(cfg, fl, dtype, mesh, plan, state_specs,
                            batch_specs, nex_spec), args, in_layouts,
                out_layouts)
    from repro_torch.engine.sharded import client_sharding
    tp = tensor_parallel(mesh, state_specs)
    round_fn = make_round_fn(make_bundle(cfg, dtype, tp), fl, mode,
                             shard=client_sharding(mesh))
    return round_fn, args, in_layouts, out_layouts


def _fsdp_round(cfg, fl, dtype, mesh, plan, state_specs, batch_specs,
                nex_spec):
    """The FSDP round (module docstring) on this rank's blocks: the
    client-sequential round of one device, run by every rank on its blocks
    of the state with the bundle's FSDP context, after the batch is
    gathered whole and cut to this data rank's rows."""
    from repro_torch.launch.mesh import axis_size
    n_data = axis_size(mesh, "data")
    tp = tensor_parallel(mesh, state_specs, fsdp=True,
                         rows_split=plan.client_batch % n_data == 0)
    inner = make_round_fn(make_bundle(cfg, dtype, tp), fl,
                          "client_sequential")

    def rows(x):
        """This data rank's rows [C, steps, B / n_data, ...] of every
        client (all of them unless ``rows_split``)."""
        if not tp.data_rows:
            return x
        position = tp.mp.place(("data",))[2]
        return x.chunk(n_data, dim=2)[position].contiguous()

    def round_fn(state, batch, n_examples, lr):
        whole = sh.gather_tree({"batch": batch, "n": n_examples},
                               {"batch": batch_specs, "n": nex_spec}, mesh)
        return inner(state, {k: rows(v) for k, v in whole["batch"].items()},
                     whole["n"], lr)

    return round_fn


def _gather_v(cfg, logits, tp):
    """Logits whole on V (serving's layout): the head's V blocks gathered
    over ``model`` where the head is split."""
    if not tfm.head_split(cfg, tp):
        return logits
    return tp.mp.all_gather(logits, -1)


def build_prefill_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                       dtype=torch.float32, *, max_len: Optional[int] = None,
                       last_only: bool = False):
    """Prefill: the prompt's forward, producing logits and the KV cache
    (of ``max_len`` positions, default the prompt's).  Returns
    ``(prefill, (params, batch) shapes, in layouts, (logits, cache)
    layouts)``; ``prefill(params, batch) -> (logits [B_loc, S, V],
    cache)`` on this rank's blocks, the logits whole on V (``last_only``:
    the last position's only, [B_loc, V], as the serving loop reads)."""
    B, S = shape.global_batch, shape.seq_len
    max_len = max_len or S
    params_shapes = param_struct(cfg)
    batch_shapes = input_specs(cfg, shape, mesh, dtype)
    cache_shapes = tfm.cache_struct(cfg, B, max_len)
    logits_shape = torch.Size((B, cfg.vocab_size) if last_only
                              else (B, S, cfg.vocab_size))
    tp = None
    layouts_in = layouts_out = None
    if mesh is not None:
        params_specs = sh.param_shardings(mesh, params_shapes, fsdp=False,
                                          ep=cfg.serve_expert_parallel)
        cache_specs = sh.cache_shardings(mesh, cache_shapes)
        tp = tensor_parallel(mesh, {"model": params_specs}, cache_specs)
        layouts_in = (params_specs, sh.serve_batch_shardings(
            mesh, {k: torch.Size(v[0]) for k, v in batch_shapes.items()}))
        layouts_out = (sh.serve_batch_shardings(mesh, logits_shape),
                       cache_specs)

    def prefill(params, batch):
        out = tfm.forward_seq(cfg, params, batch, want_cache=True,
                              want_logits=False, max_cache_len=max_len,
                              tp=tp)
        feats = out["features"][:, -1] if last_only else out["features"]
        logits = tfm.head_apply(cfg, params,
                                tfm.head_input(cfg, feats, tp), tp)
        return _gather_v(cfg, logits, tp), out["cache"]

    return (prefill, (params_shapes, batch_shapes), layouts_in, layouts_out)


def build_serve_step(cfg: ArchConfig, shape: InputShape, mesh=None,
                     dtype=torch.float32):
    """Decode: ONE new token against a cache of ``shape.seq_len``.
    Returns ``(serve, (params, tokens, cache, pos) shapes, in layouts,
    (logits, cache) layouts)``; ``serve(params, tokens [B_loc, 1], cache,
    pos) -> (logits [B_loc, 1, V], cache)`` on this rank's blocks, the
    logits whole on V and the cache updated in place.  ``pos`` is best a
    0-d int64 on the device: the step then never waits for the host."""
    B, S = shape.global_batch, shape.seq_len
    params_shapes = param_struct(cfg)
    cache_shapes = tfm.cache_struct(cfg, B, S)
    tok_shape = torch.Size((B, 1))
    args = (params_shapes, (tok_shape, torch.int64), cache_shapes,
            (torch.Size(()), torch.int64))
    tp = None
    layouts_in = layouts_out = None
    if mesh is not None:
        params_specs = sh.param_shardings(mesh, params_shapes, fsdp=False,
                                          ep=cfg.serve_expert_parallel)
        cache_specs = sh.cache_shardings(mesh, cache_shapes)
        tp = tensor_parallel(mesh, {"model": params_specs}, cache_specs)
        tok_specs = sh.serve_batch_shardings(mesh, tok_shape)
        layouts_in = (params_specs, tok_specs, cache_specs, ())
        layouts_out = (sh.serve_batch_shardings(
            mesh, torch.Size((B, 1, cfg.vocab_size))), cache_specs)

    def serve(params, tokens, cache, pos):
        logits, cache = tfm.decode_step(cfg, params, tokens, cache, pos,
                                        tp=tp)
        return _gather_v(cfg, logits, tp), cache

    return serve, args, layouts_in, layouts_out


def build_step(cfg: ArchConfig, fl: FLConfig, shape: InputShape, mesh=None,
               dtype=torch.float32):
    if shape.kind == "train":
        return build_train_step(cfg, fl, shape, mesh, dtype)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, dtype)
    return build_serve_step(cfg, shape, mesh, dtype)
