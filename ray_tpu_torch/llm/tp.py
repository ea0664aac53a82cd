"""Tensor-parallel serving: the inference engine sharded over ``tp``
devices — the PyTorch port of ``ray_tpu/llm/tp.py``.

As in the JAX package, ONE engine process drives every shard (there, a
``jax.sharding.Mesh`` and ``shard_map`` programs; here, one parameter
shard and one KV-pool shard per device, stepped in turn by the same
three step functions as the single-device engine, ``llm/model.py``
with its ``reduce`` hook). The ragged paged-attention op runs once per
shard per layer on that shard's heads, with no communication; the two
row-split products per layer are summed across the shards (Megatron's
schedule).

Layout (Megatron, as ``tp_param_specs`` says):
  - wq/wk/wv, w_gate/w_up: split by columns (output dim over tp)
  - wo, w_down:            split by rows (input dim over tp), then summed
  - embed, norms:          replicated (one copy per distinct device)
  - paged KV pool:         kv-head axis split: each shard holds Hkv/tp
                           heads of EVERY page (int8 scales split on the
                           same axis), so the page allocator stays global

Every shard's weights and pool are tensors of their own, contiguous
(the kernels refuse strided views). Shards may share a device (the
counterpart of the JAX tests' virtual CPU devices; on one card, both
shards of a tp=2 engine): their partial products are then added there.
Shards on distinct cards are summed by peer copies, every card adding the
partials in shard-device order, so each ends with the same sum.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from ray_tpu_torch.llm.engine import _SingleChipFns
from ray_tpu_torch.models.llama import (LlamaConfig, Params, matrices,
                                        resolve_device)
from ray_tpu_torch.parallel.mesh import P

TP_AXIS = "tp"

#: paged KV pool [n_layers, pages, Hkv, page_size, D]: heads split
CACHE_SPEC = P(None, None, TP_AXIS, None, None)
#: int8 KV scale arrays [n_layers, pages, Hkv, page_size]: same axis
SCALE_SPEC = P(None, None, TP_AXIS, None)


def kv_specs(quantized: bool) -> dict:
    """The spec of each leaf of ``cache.make_kv_cache``'s dict."""
    specs = {"k": CACHE_SPEC, "v": CACHE_SPEC}
    if quantized:
        specs["k_scale"] = SCALE_SPEC
        specs["v_scale"] = SCALE_SPEC
    return specs


def tp_param_specs(cfg: LlamaConfig) -> Params:
    """Spec tree for SERVING (one tp axis), distinct from
    ``models.llama.param_specs``, which targets the training mesh."""
    col = P(None, None, TP_AXIS)   # [L, d, out]: split out
    row = P(None, TP_AXIS, None)   # [L, in, d]: split in, summed after
    rep2 = P(None, None)
    return {
        "embed": rep2,
        "layers": {
            "attn_norm": rep2,
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": rep2,
            "w_gate": col, "w_up": col, "w_down": row,
        },
        "final_norm": P(None),
    }


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    if tp < 2:
        raise ValueError(f"tp must be >= 2 for a sharded engine, got {tp}")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} and "
            f"n_kv_heads={cfg.n_kv_heads}")


def build_tp_mesh(tp: int, devices: Optional[Sequence] = None,
                  device="cuda") -> List[torch.device]:
    """The shards' devices, one per shard: the first ``tp`` of
    ``devices`` (which may name one device more than once), else every
    shard on the CPU for ``device="cpu"``, else the first ``tp`` visible
    cards. Fewer than ``tp`` raises, as the JAX ``build_tp_mesh``."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = [dev] * tp
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < tp:
        raise ValueError(f"tp={tp} needs {tp} devices, have {len(devices)}")
    out = []
    for d in devices[:tp]:
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(resolve_device(d))
    return out


def sum_shards(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard's partial product -> the sum over shards, one tensor per
    shard on its device. Shards on one device are added there, in shard
    order (they then share the result tensor); across devices every
    device adds the per-device sums in device order, copied peer to peer,
    so every device holds the same values."""
    local = {}
    for p in parts:
        local[p.device] = p if p.device not in local else local[p.device] + p
    if len(local) > 1:
        sums = list(local.values())
        local = {d: _ordered_sum([t.to(d) for t in sums]) for d in local}
    return [local[p.device] for p in parts]


def _ordered_sum(ts):
    total = ts[0]
    for t in ts[1:]:
        total = total + t
    return total


class TPEngineFns(_SingleChipFns):
    """The three step functions the engine dispatches, tp-sharded: the
    single-device set's, with ``params`` and ``kv`` held as lists of
    shards (``shard_params``; ``cache.make_kv_cache`` with ``devices``
    allocates each shard's pool as ``kv_specs`` splits it) and the
    partial products summed by ``sum_shards``; the descriptor tensors on
    the first shard's device."""

    reduce = staticmethod(sum_shards)

    def __init__(self, cfg: LlamaConfig, devices: Sequence[torch.device],
                 *, decode_chunk: int, max_q_len: int, decode_rows: int):
        validate_tp(cfg, len(devices))
        super().__init__(cfg, decode_chunk, max_q_len, decode_rows)
        self.devices = list(devices)
        self.tp = len(self.devices)
        # the programs this engine dispatched: the JAX engine builds its
        # three shard_map jits per engine, so its count is the engine's
        self._programs = set()
        self._programs_lock = threading.Lock()

    def shards(self, tree):
        return tree

    def unshard(self, shards):
        return shards

    # ------------------------------------------------------------ placement

    @torch.no_grad()
    def shard_params(self, leaves, dtype) -> List[Params]:
        """One parameter dict per shard on its device from ``leaves``
        (``models.llama.init_leaves`` or ``tree_leaves``), each leaf its
        own contiguous tensor in ``dtype``, filled one matrix at a time:
        a split leaf's matrix cut along the spec's tp dim, a replicated
        leaf copied once per distinct device and shared by that device's
        shards. Nothing but the shards and one matrix is ever allocated."""
        specs = tp_param_specs(self.cfg)
        shards = [{} for _ in self.devices]
        for path, shape, parts in leaves:
            spec = specs
            for key in path:
                spec = spec[key]
            split = TP_AXIS in spec
            if split:
                dim = list(spec).index(TP_AXIS)
                sub = list(shape)
                sub[dim] //= self.tp
                own = [torch.empty(sub, dtype=dtype, device=d)
                       for d in self.devices]
            else:
                per_device = {d: torch.empty(shape, dtype=dtype, device=d)
                              for d in dict.fromkeys(self.devices)}
                own = [per_device[d] for d in self.devices]
            dsts = [matrices(t) for t in own]
            for i, part in enumerate(parts):
                if split:
                    pieces = part.chunk(self.tp,
                                        dim=dim - len(shape) + part.dim())
                    for dst, piece in zip(dsts, pieces):
                        dst[i].copy_(piece)
                else:
                    for dst in {id(t): dst for t, dst in zip(own, dsts)
                                }.values():
                        dst[i].copy_(part)
            for shard, leaf in zip(shards, own):
                node = shard
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = leaf
        return shards

    def gather_params(self, shards: List[Params]) -> Params:
        """The whole parameter dict on the first shard's device, from the
        shards (the inverse of ``shard_params``)."""
        specs = tp_param_specs(self.cfg)
        dev = self.devices[0]

        def cat(name, spec, leaves):
            if TP_AXIS not in spec:
                return leaves[0].to(dev)
            return torch.cat([t.to(dev) for t in leaves],
                             dim=list(spec).index(TP_AXIS))

        return {"embed": shards[0]["embed"].to(dev),
                "layers": {n: cat(n, specs["layers"][n],
                                  [s["layers"][n] for s in shards])
                           for n in shards[0]["layers"]},
                "final_norm": shards[0]["final_norm"].to(dev)}
