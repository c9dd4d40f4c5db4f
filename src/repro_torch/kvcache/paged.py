"""PagedKVPool: the physical KV data plane behind the paged control plane.

Port of ``repro.kvcache.paged``. ``BlockPool``/``PrefixIndex``/
``CacheManager`` own refcounts and prefix matching over abstract page ids;
this module gives those ids storage: per-layer K/V page tensors shaped
``(P + 1, page_size, Hkv, head_dim)``, stacked over the model's layer
groups, so a page written by the prefill worker is read in place by every
decode model. Handing a request to a decode model moves a block table (a
few bytes of page ids), never the KV.

Data flow:
  - prefill: ``gather_prefill_cache`` materializes the cached prefix as a
    dense working cache, the frozen base model extends it, and
    ``scatter_from_dense`` writes the fresh page-aligned rows back into the
    pool with the ``paged_write`` kernel (its plain version on the CPU).
  - decode: ``make_decode_cache`` wires the pool tensors and per-sequence
    block tables into a model cache; the decode step appends each token's
    K/V to the sequence's private tail page.

Every update here is IN PLACE. On the TPU the reference pairs buffer
donation with ``decode_state``/``absorb_decode_state`` (and a donated
``copy_page``) so XLA can update pages without copying the pool; torch
mutates tensors directly, so those pairs have no counterpart: the decode
step and ``copy_page`` write the pool's own tensors.

Physical row 0 is the padding sentinel (``BlockPool.SENTINEL``): it is never
allocated, so zero-padded block tables can never alias live KV.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.paged_write import paged_write


class PagedKVPool:
    """Per-layer physical K/V page tensors for a pure global-attention
    stack. Full ``layer_pattern`` groups are stacked on a leading axis
    (matching the model's stacked group params); tail layers are stored
    one by one."""

    def __init__(self, cfg: ModelConfig, num_pages: int, page_size: int,
                 device=None):
        if not self.supports(cfg):
            raise ValueError(
                f"paged KV plane requires a pure global-attention decoder "
                f"(got pattern {cfg.layer_pattern}, encdec={cfg.is_encdec})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_pages = num_pages            # usable pages (ids 1..num_pages)
        self.page_size = page_size
        self.hkv, self.hd = cfg.n_kv_heads, cfg.head_dim
        self.dtype = torch_dtype(cfg.dtype)
        pat = cfg.layer_pattern
        self.n_full = cfg.n_layers // len(pat)
        n_tail = cfg.n_layers % len(pat)

        # +1 physical row: row 0 is the never-allocated padding sentinel
        shape = (num_pages + 1, page_size, self.hkv, self.hd)

        def zeros(lead=()):
            return torch.zeros(lead + shape, dtype=self.dtype,
                               device=self.device)

        self.k_groups = {f"pos{i}": zeros((self.n_full,))
                         for i in range(len(pat))} if self.n_full else {}
        self.v_groups = {g: zeros((self.n_full,)) for g in self.k_groups}
        self.k_tail = [zeros() for _ in range(n_tail)]
        self.v_tail = [zeros() for _ in range(n_tail)]

    @staticmethod
    def supports(cfg: ModelConfig) -> bool:
        """True if every layer's sequence state is global-attention KV."""
        return (all(k == ATTN for k in cfg.layer_kinds())
                and not cfg.is_encdec and cfg.n_heads > 0
                and cfg.input_mode == "tokens")

    def layers(self):
        """(k_pages, v_pages) per layer, in execution order (group g's
        layer i is the view ``k_groups[g][i]``)."""
        ks, vs = [], []
        for layer in range(self.n_full):
            for g in self.k_groups:
                ks.append(self.k_groups[g][layer])
                vs.append(self.v_groups[g][layer])
        return ks + list(self.k_tail), vs + list(self.v_tail)

    # ------------------------------------------------------------------
    # prefill side
    # ------------------------------------------------------------------
    def gather_prefill_cache(self, block_table, n_valid: int):
        """Materialize a dense B=1 working cache whose first ``n_valid`` rows
        come from the pool pages named by ``block_table`` (slots beyond
        ``n_valid`` are masked via kpos=-1)."""
        bt = torch.as_tensor(np.asarray(block_table, np.int64),
                             device=self.device)
        T = len(block_table) * self.page_size
        f = self.hkv * self.hd
        ar = torch.arange(T, dtype=torch.int32, device=self.device)
        kpos = torch.where(ar < n_valid, ar, -1)[None]         # (1, T)

        groups = {}
        for g, kp in self.k_groups.items():
            groups[g] = {
                "k": kp[:, bt].reshape(self.n_full, T, f)[:, None],
                "v": self.v_groups[g][:, bt].reshape(self.n_full, T, f)[:, None],
                "kpos": kpos.expand(self.n_full, 1, T).clone()}
        tail = [{"k": kt[bt].reshape(T, f)[None],
                 "v": self.v_tail[i][bt].reshape(T, f)[None],
                 "kpos": kpos.clone()}
                for i, kt in enumerate(self.k_tail)]
        return {"groups": groups, "tail": tail}

    def scatter_from_dense(self, cache, block_table, start_page: int,
                           n_new_pages: int):
        """Write pages ``[start_page, start_page + n_new_pages)`` of a dense
        B=1 working cache into their physical pool pages (paged_write).

        Rows come from the *updated* dense cache, so a page that was
        partially cached before this prefill is rewritten whole: every write
        is page-aligned, the kernel's contract."""
        if n_new_pages <= 0:
            return
        page = self.page_size
        bt_tail = np.asarray(
            block_table[start_page:start_page + n_new_pages], np.int32)[None]
        nvalid = np.full((1,), n_new_pages, np.int32)
        s0, span = start_page * page, n_new_pages * page

        def rows(leaf_k):                      # (..., 1, cap, f) -> new KV rows
            return leaf_k[..., 0, s0:s0 + span, :].reshape(
                leaf_k.shape[:-3] + (span, self.hkv, self.hd)).contiguous()

        for g in self.k_groups:
            # ONE launch per group: the stacked (n_full, P, page, H, D) layer
            # axis folds into paged_write's batch by viewing the pool as
            # (n_full * P, ...) and offsetting each layer's block table by
            # its pool stride.
            kg, vg = self.k_groups[g], self.v_groups[g]
            P = kg.shape[1]
            bt_l = bt_tail + (np.arange(self.n_full, dtype=np.int32) * P)[:, None]
            nv_l = np.full((self.n_full,), n_new_pages, np.int32)
            paged_write(rows(cache["groups"][g]["k"]),
                        rows(cache["groups"][g]["v"]),
                        kg.view((self.n_full * P,) + kg.shape[2:]),
                        vg.view((self.n_full * P,) + vg.shape[2:]),
                        bt_l, nv_l)
        for i in range(len(self.k_tail)):
            paged_write(rows(cache["tail"][i]["k"])[None],
                        rows(cache["tail"][i]["v"])[None],
                        self.k_tail[i], self.v_tail[i], bt_tail, nvalid)

    # ------------------------------------------------------------------
    # decode side
    # ------------------------------------------------------------------
    def copy_page(self, src: int, dst: int):
        """Copy-on-write: clone one physical page (all layers) in place.
        Used when a decode holder must append into a partially filled
        shared page."""
        for a in list(self.k_groups.values()) + list(self.v_groups.values()):
            a[:, dst].copy_(a[:, src])
        for a in self.k_tail + self.v_tail:
            a[dst].copy_(a[src])

    def make_decode_cache(self, block_tables: torch.Tensor):
        """Wire the pool tensors and (B, npages) int32 block tables into a
        model cache for a batched paged decode step (see
        ``attention.attn_apply``). The step writes the pool in place."""
        return {"groups": {g: {"k_pages": self.k_groups[g],
                               "v_pages": self.v_groups[g],
                               "block_tables": block_tables}
                           for g in self.k_groups},
                "tail": [{"k_pages": k, "v_pages": v,
                          "block_tables": block_tables}
                         for k, v in zip(self.k_tail, self.v_tail)]}
