"""The ``Codec`` protocol (port of ``repro/compress/codec.py``): pluggable
uplink/downlink compression of parameter trees.

A codec maps a tree (weights or weight deltas) to a *wire payload*, a list
with one entry per leaf whose tensors are exactly the bytes that would
cross the network, and back.  ``nbytes`` reports the true wire size of a
payload; ``wire_bytes`` the size of one message, computed from the bound
leaf shapes (it equals the JAX package's ``wire_bytes``).

Stateful codecs (error feedback) thread a per-leaf ``state`` list through
``encode``; the server keeps one state per client across rounds.
Stochastic codecs take their uniform offsets as ``noise``, one tensor per
leaf: ``jax.random`` draws cannot be reproduced in PyTorch, so the caller
owns the randomness (None selects the deterministic variant).

Level ladder (adaptive compression, ``repro_torch.control``): a
ladder-capable codec is bound once at its top (capacity) level with
``set_ladder``; ``encode(..., level=)`` then takes a 0-d int32 tensor on
the data's device that masks each payload down to the effective rung,
while the payload keeps its capacity shape (so a captured graph replays at
any level).  ``level_bytes`` reports what a real wire would carry per
rung, for ``CommLog``'s effective-bytes accounting.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_unflatten


class Codec:
    """Base codec: bind to a template tree, then encode/decode leaves.

    Subclasses implement the per-leaf hooks ``_encode_leaf(x_flat, state,
    noise, i)`` -> (leaf_payload, new_leaf_state), ``_decode_leaf(payload,
    i)`` -> x_flat and ``_leaf_wire_bytes(i)``, or ``_encode_leaves(leaves,
    state, noise)`` -> (payload, new_state) and ``_decode_leaves(payload)``
    -> [x_flat, ...] to encode or decode a whole message at once; the base
    class handles flatten / unflatten, shape restore and byte accounting.
    """

    name = "identity"
    stateful = False          # True -> per-client state (error feedback)
    uses_noise = False        # True -> encode consumes uniform offsets

    def bind(self, template_tree) -> "Codec":
        """Record the tree structure, leaf shapes, dtypes and device."""
        leaves = tree_leaves(template_tree)
        self._template = template_tree
        self._shapes = [tuple(x.shape) for x in leaves]
        self._dtypes = [x.dtype for x in leaves]
        self._device = leaves[0].device
        return self

    def _n(self, i) -> int:
        """Element count of bound leaf ``i``."""
        n = 1
        for d in self._shapes[i]:
            n *= d
        return n

    # -- per-leaf hooks -------------------------------------------------
    def _encode_leaf(self, x, state, noise, i) -> Tuple[Any, Any]:
        return x, state

    def _decode_leaf(self, payload, i):
        return payload

    def _encode_leaf_level(self, x, state, noise, i, level):
        raise NotImplementedError(
            f"codec {self.name!r} does not support level-parameterized "
            "encode (no compression ladder)")

    def _encode_leaves(self, leaves, state, noise, level=None):
        payload, new_state = [], []
        for i, (x, s, u) in enumerate(zip(leaves, state, noise)):
            if level is None:
                p, ns = self._encode_leaf(x, s, u, i)
            else:
                p, ns = self._encode_leaf_level(x, s, u, i, level)
            payload.append(p)
            new_state.append(ns)
        return payload, new_state

    def _decode_leaves(self, payload):
        return [self._decode_leaf(p, i) for i, p in enumerate(payload)]

    def _init_leaf_state(self, i):
        return None

    def _leaf_wire_bytes(self, i) -> int:
        return 4 * self._n(i)     # the float32 leaf

    # -- level ladder ---------------------------------------------------
    _ladder = None            # ascending effective levels; None -> static

    def set_ladder(self, values) -> "Codec":
        raise ValueError(
            f"codec {self.name!r} has no compression ladder; adaptive "
            "controllers need a ladder-capable uplink codec "
            "(topk/topk_noef/quant/int8/int4)")

    def level_bytes(self) -> Tuple[int, ...]:
        """Effective wire bytes per ladder level (bind + set_ladder first)."""
        raise ValueError(f"codec {self.name!r} has no compression ladder")

    # -- public API -----------------------------------------------------
    def init_state(self, template_tree=None) -> List[Any]:
        """Fresh per-client codec state: one entry per leaf (an EF residual
        tensor, or None when the codec is stateless)."""
        if template_tree is not None:
            self.bind(template_tree)
        return [self._init_leaf_state(i) for i in range(len(self._shapes))]

    def encode(self, tree, state=None,
               noise: Optional[List[torch.Tensor]] = None,
               level: Optional[torch.Tensor] = None):
        """tree -> (payload, new_state).  ``noise``: one tensor of offsets
        in [0, 1) per leaf for stochastic codecs; None selects the
        deterministic variant.  ``level`` (a 0-d int32 tensor on the
        data's device) selects the effective rung of a bound ladder
        (``set_ladder``); None encodes at the static configuration, by the
        code without the ladder."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self._shapes):
            raise ValueError(f"codec bound to a {len(self._shapes)}-leaf "
                             f"tree, got {len(leaves)} leaves")
        if state is None:
            state = self.init_state()
        if noise is None:
            noise = [None] * len(leaves)
        flat = [x.reshape(-1).float() for x in leaves]
        if level is None:
            return self._encode_leaves(flat, state, noise)
        return self._encode_leaves(flat, state, noise, level=level)

    def decode(self, payload):
        """payload -> tree (shapes and dtypes of the bound template)."""
        leaves = [x.reshape(self._shapes[i]).to(self._dtypes[i])
                  for i, x in enumerate(self._decode_leaves(payload))]
        return tree_unflatten(self._template, leaves)

    def nbytes(self, payload) -> int:
        """True wire bytes of one payload (sum over transmitted buffers)."""
        return int(sum(t.numel() * t.element_size()
                       for t in tree_leaves(payload)))

    def wire_bytes(self) -> int:
        """Per-message wire bytes, from the bound shapes."""
        return sum(self._leaf_wire_bytes(i) for i in range(len(self._shapes)))


class IdentityCodec(Codec):
    """No compression: the payload is the raw float32 tree (baseline)."""

    name = "identity"
