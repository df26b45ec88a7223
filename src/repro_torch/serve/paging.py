"""Paged KV cache: page pool + page-aware scheduler.

Port of `repro/serve/paging.py`. Pure host-side bookkeeping — no torch.
Replaces "one contiguous (T,) slot row per request" with fixed-size KV
*pages* and a per-request block table:

  PagePool        free list + refcounted page ownership over a device
                  pool of `n_pages * page` cache rows, plus the host
                  block table the decode step consumes.
  PagedScheduler  SlotScheduler subclass whose admission reserves pages
                  (worst case: ceil((prompt + max_new) / page) for the
                  request's whole life, so the block table is static per
                  request), whose prefix hits ALIAS full donor pages
                  (refcount++) instead of cloning rows, and whose
                  retirement frees the slot row at once while the
                  retained prefix keeps only its page list.

Sharing + tiers:

  * Prefix aliasing: for plans without ring windows, a hit aliases the
    donor's FULL prefix pages
    (p // page of them) and copies only the partial boundary page into
    the sharer's own fresh page (models/decode.copy_pages). Aliased pages
    are append-only for their donor (its writes land at rows >= depth >=
    p) and never written by the sharer (its first write is row p, inside
    its own pages), so sharing is exact.
  * Ring plans (sliding windows) copy every prefix page instead of
    aliasing (alias_ok=False): a sharer's ring writes wrap back into its
    low pages, which would overwrite the donor's rows.
  * Tiered spill: evicting a retained entry first gathers its pages to a
    host blob (the engine's spill_fn) when a host budget is configured.
    The entry stays matchable with spilled=True; a later hit scatters the
    blob into the new request's own pages (models/decode.scatter_pages).
    The host tier is itself LRU-bounded (host_budget pages).

Eviction cannot deadlock on sharing: releasing a shared entry frees only
pages whose refcount reaches zero, so the reclaim loop walks victims until
enough pages are free or no victim remains (the queue head then waits).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.scheduler import (PrefixEntry, RequestState,
                                         SlotScheduler, serve_clock)


class PagePool:
    """Free list + refcounts over `n_pages` fixed-size pages of a device
    row pool (`n_pages * page` rows). Pages are owned by slots while a
    request is in flight and by retained PrefixEntries afterwards; a page
    is freed when its refcount reaches zero."""

    def __init__(self, n_pages: int, page: int, n_slots: int,
                 max_len: int):
        assert n_pages >= 1 and page >= 1
        self.n_pages = n_pages
        self.page = page
        self.n_slots = n_slots
        self.npages_max = -(-max_len // page)         # ceil
        assert n_pages >= self.npages_max, \
            f"pool of {n_pages} pages cannot hold one max_len request " \
            f"({self.npages_max} pages)"
        self._free: Deque[int] = deque(range(n_pages))
        self.ref = [0] * n_pages
        self.slot_pages: Dict[int, List[int]] = {}
        self.pages_in_use_peak = 0
        self.alias_acquisitions = 0
        self.fresh_acquisitions = 0
        self.spills = 0
        self.restores = 0
        self.host_dropped = 0

    def pages_for(self, rows: int) -> int:
        return -(-rows // self.page) if rows > 0 else 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def allocate(self, slot: int, *, alias: List[int],
                 n_fresh: int) -> List[int]:
        """Assign `alias` (shared donor pages, refcount++) plus `n_fresh`
        newly acquired pages to `slot`. Returns the fresh pages."""
        assert slot not in self.slot_pages
        assert n_fresh <= len(self._free)
        for pg in alias:
            assert self.ref[pg] > 0, "aliasing an unowned page"
            self.ref[pg] += 1
        fresh = [self._free.popleft() for _ in range(n_fresh)]
        for pg in fresh:
            assert self.ref[pg] == 0
            self.ref[pg] = 1
        self.alias_acquisitions += len(alias)
        self.fresh_acquisitions += n_fresh
        self.slot_pages[slot] = list(alias) + fresh
        self.pages_in_use_peak = max(self.pages_in_use_peak,
                                     self.pages_in_use)
        return fresh

    def release_pages(self, pages: List[int]) -> None:
        for pg in pages:
            self.ref[pg] -= 1
            assert self.ref[pg] >= 0, "page refcount underflow"
            if self.ref[pg] == 0:
                self._free.append(pg)

    def release_slot(self, slot: int) -> None:
        self.release_pages(self.slot_pages.pop(slot, []))

    def take_slot_pages(self, slot: int) -> List[int]:
        """Transfer page ownership out of a slot (refcounts unchanged)."""
        return self.slot_pages.pop(slot)

    def block_table(self) -> np.ndarray:
        """(n_slots, npages_max) int32: logical page j of slot b lives at
        physical page bt[b, j]. Unassigned entries are 0: reads through
        them are masked by the per-slot lengths and writes are dropped
        into the pool's sink page (models/decode.init_paged_cache)."""
        bt = np.zeros((self.n_slots, self.npages_max), np.int32)
        for slot, pages in self.slot_pages.items():
            bt[slot, :len(pages)] = pages
        return bt

    @property
    def page_share_rate(self) -> float:
        total = self.alias_acquisitions + self.fresh_acquisitions
        return self.alias_acquisitions / total if total else 0.0


class PagedScheduler(SlotScheduler):
    """Page-aware SlotScheduler: admission reserves worst-case pages up
    front, prefix hits alias or copy donor PAGES (the engine's actions
    ride in RequestState.paged), retirement frees the slot row at once
    and retains only the prefix's page list, and eviction spills cold
    pages to a host tier before releasing them. alias_ok=False (ring
    plans) copies every prefix page of a hit instead of aliasing the full
    ones.

    st.paged actions for the engine (processed in admission order):
      fresh    : list of newly acquired pages
      alias    : count of leading donor pages shared by refcount
      copy_src / copy_dst : physical pages to clone (the partial boundary
                 page of an aliased hit; every prefix page of a ring hit)
      blob / blob_dst     : host blob to scatter into the slot's own
                 prefix pages (hit on a spilled entry)
    """

    def __init__(self, n_slots: int, max_len: int, *, pool: PagePool,
                 prefix_cache: bool = False,
                 prefix_usable_len=None,
                 alias_ok: bool = True,
                 spill_fn: Optional[
                     Callable[[PrefixEntry], object]] = None,
                 host_budget: int = 0):
        super().__init__(n_slots, max_len, prefix_cache=prefix_cache,
                         prefix_usable_len=prefix_usable_len)
        self.pool = pool
        self.alias_ok = alias_ok
        self.spill_fn = spill_fn
        self.host_budget = int(host_budget)
        # paged retained entries hold PAGES, not slots: keyed by rid
        self.retained: Dict[int, PrefixEntry] = {}
        self._host_order: "OrderedDict[int, int]" = OrderedDict()
        self._host_used = 0

    # -- slots are never retained in paged mode ----------------------------
    def _acquire_slot(self) -> Optional[int]:
        return self._free.popleft() if self._free else None

    def _donor_pages(self, entry: PrefixEntry) -> List[int]:
        if entry.state is not None:                   # resident donor
            return self.pool.slot_pages[entry.slot]
        return entry.pages or []

    # -- tiered eviction ---------------------------------------------------
    def _evict_retained(self, entry: PrefixEntry,
                        want_blob: bool = False):
        """Release a retained entry's device pages, first gathering them
        to a host blob when a spill tier exists (or the caller needs the
        rows). Returns the blob (None when no spill path)."""
        blob = None
        if self.spill_fn is not None and entry.pages and \
                (want_blob or self.host_budget > 0):
            blob = self.spill_fn(entry)
            self.pool.spills += 1
        self.pool.release_pages(entry.pages or [])
        entry.pages = None
        self.retained.pop(entry.rid, None)
        if blob is not None and self.host_budget > 0:
            entry.blob = blob
            entry.spilled = True
            self._host_order[entry.rid] = self.pool.pages_for(entry.depth)
            self._host_used += self._host_order[entry.rid]
            self._host_evict_to_budget()
        else:
            self.index.remove(entry.rid)
        return blob

    def _host_evict_to_budget(self) -> None:
        for rid in list(self._host_order):
            if self._host_used <= self.host_budget:
                break
            e = self.index.get(rid)
            if e is not None and e.refcount > 0:
                continue                              # pinned mid-batch
            self._host_used -= self._host_order.pop(rid)
            self.pool.host_dropped += 1
            if e is not None:
                e.blob = None
                e.spilled = False
                self.index.remove(rid)

    def _ensure_pages(self, n: int,
                      keep: Optional[PrefixEntry] = None) -> bool:
        """Free device pages until `n` are available, LRU-spilling
        retained entries (never `keep`, never pinned ones). Releasing a
        shared entry may free fewer pages than it owned, so keep walking
        victims."""
        while self.pool.free_pages < n:
            victims = [e for e in self.retained.values()
                       if e.refcount == 0 and e is not keep]
            if not victims:
                return False
            self._evict_retained(min(victims, key=lambda e: e.last_used))
        return True

    @property
    def host_pages_used(self) -> int:
        return self._host_used

    # -- admission ---------------------------------------------------------
    def admit(self) -> List[RequestState]:
        admitted: List[RequestState] = []
        pool = self.pool
        while self._queue:
            req = self._queue[0]
            donor, p = (self._match_prefix(req) if self.prefix_cache
                        else (None, 0))
            if donor is not None:
                donor.refcount += 1       # pin across page reclamation
            slot = self._acquire_slot()
            if slot is None:
                if donor is not None:
                    donor.refcount -= 1
                break
            need = pool.pages_for(len(req.prompt) + req.sampling.max_new)
            n_pp = pool.pages_for(p)
            alias: List[int] = []
            copy_src: Optional[List[int]] = None
            blob = None
            if donor is not None and p > 0:
                if donor.spilled:
                    blob = donor.blob
                    self._host_order.move_to_end(donor.rid)
                    pool.restores += 1
                else:
                    src = self._donor_pages(donor)
                    if self.alias_ok:
                        alias = list(src[: p // pool.page])
                    if len(alias) < n_pp:
                        copy_src = list(src[len(alias): n_pp])
            if not self._ensure_pages(need - len(alias), keep=donor):
                # last resort: the matched donor itself is the only
                # reclaimable capacity. Pins held by earlier admissions of
                # this batch don't block it: the engine performs their
                # copies first, before this slot's restore touches the
                # recycled pages.
                batch_pins = sum(1 for a in admitted
                                 if a.donor_entry is donor)
                handed = False
                if donor is not None and donor.retained \
                        and not donor.spilled \
                        and donor.refcount == 1 + batch_pins:
                    blob = self._evict_retained(donor, want_blob=True)
                    alias, copy_src = [], None
                    handed = self._ensure_pages(need)
                if not handed:
                    if donor is not None:
                        donor.refcount -= 1
                    self._free.appendleft(slot)
                    break
            self._queue.popleft()
            fresh = pool.allocate(slot, alias=alias,
                                  n_fresh=need - len(alias))
            slot_pages = pool.slot_pages[slot]
            st = RequestState(request=req, slot=slot)
            st.paged = {"fresh": fresh, "alias": len(alias)}
            # a hit only counts if the prefix rows are reachable
            # (aliased, copyable, or restorable from a blob)
            if donor is not None and p > 0 and \
                    (alias or copy_src or blob is not None):
                st.prefix_len, st.prefix_src = p, st.slot
                st.pos = st.cursor = p
                if blob is not None:
                    st.paged["blob"] = blob
                    st.paged["blob_dst"] = slot_pages[:n_pp]
                elif copy_src:
                    st.paged["copy_src"] = copy_src
                    st.paged["copy_dst"] = slot_pages[len(alias): n_pp]
            if donor is not None:
                st.donor_entry = donor    # release_donor() unpins
                if self.index.get(donor.rid) is donor:
                    self.index.touch(donor)
            self.active[slot] = st
            if self.prefix_cache:
                self.index.insert(PrefixEntry(req.rid, slot, req.prompt,
                                              state=st))
            admitted.append(st)
        return admitted

    # -- retirement --------------------------------------------------------
    def retire(self, slot: int) -> RequestState:
        """Finish the request in `slot`. The slot row is ALWAYS recycled
        at once; a retained entry keeps only the pages covering its
        written depth, the worst-case tail reservation is released."""
        st = self.active.pop(slot)
        st.t_done = serve_clock()
        self.finished[st.request.rid] = st
        pages = self.pool.take_slot_pages(slot)
        entry = self.index.get(st.request.rid) if self.prefix_cache \
            else None
        if entry is not None:
            entry.retain()
            keep = self.pool.pages_for(st.pos)
            entry.pages = pages[:keep]
            self.pool.release_pages(pages[keep:])
            self.retained[entry.rid] = entry
            self.index.touch(entry)
        else:
            self.pool.release_pages(pages)
        self._free.append(slot)
        return st
