"""Serving engine: continuous batching over slot KV caches or a page pool.

Port of `repro/serve/engine.py`, greedy and seeded sampled requests, with
prefix reuse, paging and self-speculative decoding. Two decode surfaces
share one sampler (serve/sampling.sample_rows):

* submit()/step()/collect()/stream()/run() — continuous batching. Requests
  are admitted into cache slots by serve/scheduler.SlotScheduler; every
  step advances EVERY active slot at its own depth (per-slot (B,) position
  tensor). A prefilling slot consumes its next chunk of prompt tokens
  (up to `prefill_chunk` per step); a decoding slot consumes its last
  sampled token. Finished requests retire at once and their slot is
  recycled.

* generate() — static batch (one-token prefill + scalar-pos decode loop),
  the oracle the continuous path must match token for token. It always
  runs on contiguous caches.

Prefix reuse (prefix_cache=True, the default): admission matches each
request against the scheduler's PrefixIndex. A contiguous hit copies the
donor slot's first p rows (models/decode.copy_prefix); a paged hit
aliases the donor's full pages and copies its boundary page
(copy_pages) or restores a spilled blob (scatter_pages). Either way the
slot's repetition-penalty seen row is seeded from the prefix ids and only
the prompt suffix is prefilled.

Paging (paged=True): the slot caches become one row pool of `n_pages`
pages of `page_size` rows (models/decode.init_paged_cache) shared through
a per-slot block table (serve/paging.py). Admission reserves a request's
worst-case pages, so n_slots may over-commit the pool; retained prefixes
hold pages, not slots, and spill to a host tier of `host_spill_pages`
pages when the pool runs short.

Quantized caches (cfg.kv_cache_dtype int8 | fp8), as in the reference:
admission zeroes a contiguous slot's scale rows (reset_slot, unless the
slot is its own donor) or a paged request's fresh pages' scale rows
(reset_pages, never an aliased page), so stale code rows dequantize to
exact 0; prefix hits copy codes and scales together.

Sliding-window plans (ring caches, models/decode.py), as in the
reference: prefill feeds one token per step (a chunk's ring writes would
overwrite keys its earlier tokens still need), a prefix hit is refused
when the donor decoded past max(p, W) (its ring wrapped over prefix
rows), and a paged hit copies every prefix page instead of aliasing the
full ones (a sharer's ring writes wrap back into its low pages).

Recurrent plans (rwkv or mamba segments: RWKV-6 and the zamba hybrid,
whose shared attention invocations keep unstacked caches the row
helpers are told of by name), as in the reference: prefill feeds one
token per step (the state advances token by token), admission zeroes the
slot's state (models/decode.reset_slot) unless the slot is its own donor,
and a prefix hit is valid only when the donor stopped at the prefix
boundary (depth == p), its state then copied with the rows. Paged, the
state stays per slot beside the pool, and recurrent plans get no prefix
reuse: a retained entry owns only pages, its slot's state recycled.
Deviation from the reference, contiguous: every step runs all slots,
idle ones on a dummy token, and a retained donor's state would drift
with them; the reference lets it drift, so a hit on a donor retired a
few steps earlier serves other tokens than a cold prefill. The port
saves the retained slots' state before each step and restores it
after.

Seeded sampling, as in the reference: a request's base key is
jax.random.key(seed), seed defaulting to its request id, rebuilt by the
port's threefry2x32 (repro_torch/prng.py); token t is drawn under
fold_in(base, t), so a request's stream depends on neither its batch nor
the scheduling, and a seeded request gives the JAX Engine's tokens.

Self-speculative decoding (speculative=True | SpecConfig), as in the
reference (serve/speculative.py): when every active slot decodes, a
step is one ROUND: k draft steps through the first D layers and AltUp's
composed predictors, one chunk verify of the k + 1 tokens, the accepted
drafts and a correction or bonus token committed (eos and stops cut a
round on the host), ring rows rolled back from a pre-round snapshot. The
draft length adapts to the accept rate (AdaptiveK), capped by each
slot's budget and, on a ring plan, so that one round never wraps a ring
row onto itself. Recurrent plans decode normally. A round in which no
slot may draft runs the normal step.

Each step hands the attention layers the per-slot depths: cache reads
are sliced to a power-of-two `kv-len bucket` >= the deepest slot, and on
the card S=1 attention runs through the ragged decode kernel (its paged
variant under paging), which also skips rows past each slot's own depth.
Only the (B,) sampled ids (and (B,) logprobs when asked for) leave the
device.

CUDA graphs, the counterpart of the reference's jitted step. Every step
goes through one static-buffer step function (`_static_step`): the
host fills pinned mirrors of the step's inputs (tokens, pos, n_valid,
rep_pen, and a sampled step's temperature, filters, keys and sample
indices; the paged block table when admission or retirement changed
it), which are copied into device buffers that never move, and the step
reads only those, the caches and `seen`, all written in place. On the
card a pure-decode step (chunk width 1: every step of a recurrent or ring
plan) replays a CUDA graph of that function, captured at the first step
of its static shape (kv bucket, logprobs or not, sampled or not: an
all-greedy batch replays a graph without the sampler) after a warm-up on
a side stream (`StepGraphs`); a step that feeds a prefill chunk (C > 1)
calls the function eagerly, by the rule of its shape. On the CPU the
function is always called directly. A capture that fails raises: no
replayable step runs eagerly instead. Retained recurrent donors are saved
before and restored after the step, outside the graph. A speculative
round replays graphs of its own on the card, never eager (`_spec_round`):
the snapshot, the draft and the pre-verify ring restore in one per (k, kv
bucket, sampled), the verify in one per (k, kv bucket, logprobs,
sampled), the post-verify restore in one per k, over static buffers
(`RoundBuffers`); the draft's seen table is a copy made inside its graph.
A draft warm-up leaves the rings as it found them (it ends in its own
restore); a verify warm-up's ring writes are restored before its
capture.

Tensor parallelism (mesh=, sharding.py): every rank of the mesh runs
this engine on the same requests in the same order, so every rank's
scheduler, prefix index and page allocator make the same decisions.
Over the "model" axis the engine shards the full parameters it is given,
its caches hold the rank's kv heads (and recurrent heads), each step runs
the attention, FFN and recurrent blocks sharded with their all-reduces
and all-gathers the logits, and every rank samples the same ids from
them. Over the batch axes ("pod", "data"), when their size D divides
n_slots, a rank holds the caches, seen rows and step rows of its n_slots
/ D slots (sharding.slot_range), samples its own rows from the
per-request keys, and the step's ids (and logprobs) are all-gathered over
the batch group, so every scheduler sees every slot's ids; a speculative
round all-gathers its committed tokens and counts, so every rank's
AdaptiveK reads the same accept counts. A prefix hit whose donor slot
another data rank holds moves the donor's rows to the destination's
owner by a broadcast within the batch group (never a gather of whole
caches). generate() splits its rows the same way. Paged, every batch
rank holds the whole row pool (the reference's paged_cache_pspecs: pool
rows whole, kv heads over "model") and its slots' recurrent state; each
scheduler allocates every slot's pages, a rank steps only its slots
through their block-table rows, and at the end of each step (and of
each speculative round, after its ring rollback) one all-gather over
the batch group carries the physical rows the rank wrote and their
values of every layer (codes and scales) to the others, which scatter
them into their pools (decode.sync_pool): every rank's pool stays
bitwise equal, so aliased prefix pages, page copies and the spill tier
read the same rows everywhere. When D does not divide n_slots (one or a
few long-context slots), every rank steps every slot and, contiguous, a
slot's attention rows are split over the ranks that compute the same
heads (sharding.SeqSplit / RowShard, the reference's tiny-batch
cache_pspecs): each rank writes the rows it owns and the attention
merges the ranks' partial softmax states over the group (the decode
kernel's split pass on the rank's rows, the workspaces all-gathered and
merged by its merge kernel). Over NCCL the collectives are captured in
the step graphs like any kernel (the warm-up on the side stream runs
them first); a gloo group's collectives cannot be captured, so on CUDA
under gloo every step runs eagerly (graph_stats says so, captures 0).
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng, resolve_device
from repro_torch import sharding as sh
from repro_torch.config import ModelConfig
from repro_torch.models.decode import (copy_pages, copy_prefix,
                                       decode_sample_step, decode_step,
                                       gather_pages, init_cache,
                                       init_paged_cache, kv_quant_spec,
                                       prefill, prefix_views, reset_pages,
                                       reset_slot,
                                       restore_recurrent, restore_rows,
                                       save_recurrent, scatter_pages,
                                       shared_segments, snapshot_rows,
                                       split_row_offsets, sync_pool,
                                       written_pool_rows)
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import layer_plan
from repro_torch.serve.sampling import (Completion, SamplingParams,
                                        base_key_data, blank_slot_params,
                                        fill_slot_params, key_data_of,
                                        sample_rows, update_seen)
from repro_torch.serve.paging import PagePool, PagedScheduler
from repro_torch.serve.scheduler import SlotScheduler, serve_clock
from repro_torch.serve.speculative import (AdaptiveK, SpecConfig,
                                           default_draft_layers, draft_round,
                                           spec_verify_step)


def kv_bucket(needed: int, lo: int, cap: int) -> int:
    """Static kv read-slice length: smallest power-of-two >= needed
    (floored at `lo`, capped at `cap`). needed > cap is an ERROR: a
    clamped bucket would silently truncate the cache read."""
    if lo < 1:
        raise ValueError(f"kv_bucket floor must be >= 1, got lo={lo} "
                         f"(lo <= 0 never reaches `needed` by doubling)")
    if needed > cap:
        raise ValueError(
            f"kv_bucket: needed={needed} exceeds the cache capacity "
            f"cap={cap}; a clamped bucket would silently truncate the "
            f"cache read — reject the request at admission instead")
    b = lo
    while b < needed:
        b *= 2
    return min(b, cap)


def _spill_entry(caches, page: int,
                 entry) -> Dict[str, Dict[str, torch.Tensor]]:
    """PagedScheduler spill_fn: gather a retained entry's pages on the
    device, then copy the blob to the host, BEFORE the scheduler releases
    the pages."""
    blob = gather_pages(caches, entry.pages, page=page)
    return {si: {n: t.cpu() for n, t in leaves.items()}
            for si, leaves in blob.items()}


# the step inputs only a sampled step reads
_SAMPLING = ("temperature", "top_k", "top_p", "min_p", "key", "sample_idx")


def _sparam_names(any_sampled: bool) -> Tuple[str, ...]:
    """The slot parameters a step reads: rep_pen, and the sampling ones
    when a slot samples."""
    return ("rep_pen",) + (_SAMPLING if any_sampled else ())


class StepInputs:
    """The static device buffers of one step width C and their host
    mirrors (pinned on the card): tokens (B, C), pos (B,), nval (B,)
    int64 and rep_pen (B,) f32; for a sampled step also temperature,
    top_p, min_p (B,) f32, top_k, sample_idx (B,) int64 and the key
    words (B, 2) int64 (prng's word type); `extra`: more (B,) int64
    buffers. The engine fills `host` (numpy views of the mirrors) and
    `upload()`s them; the device tensors never move, so a captured step
    reads each step's inputs from them. The sampling mirrors are written
    and uploaded only by a step that samples. A mirror is rewritten only
    after the previous step's ids reached the host, which waits for that
    step's copies."""

    def __init__(self, B: int, C: int, device: torch.device,
                 extra: Tuple[str, ...] = ()):
        pin = device.type == "cuda"
        f32, i64 = torch.float32, torch.long
        specs = {"tokens": ((B, C), i64), "pos": ((B,), i64),
                 "nval": ((B,), i64), "rep_pen": ((B,), f32),
                 "temperature": ((B,), f32), "top_k": ((B,), i64),
                 "top_p": ((B,), f32), "min_p": ((B,), f32),
                 "key": ((B, prng.KEY_WIDTH), i64),
                 "sample_idx": ((B,), i64)}
        specs.update({name: ((B,), i64) for name in extra})
        self._pairs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.host: Dict[str, np.ndarray] = {}
        for name, (shape, dtype) in specs.items():
            h = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            d = torch.zeros(shape, dtype=dtype, device=device)
            self._pairs[name] = (h, d)
            self.host[name] = h.numpy()
            setattr(self, name, d)

    def upload(self, *names: str) -> None:
        """Copy the named mirrors (all of them by default) to the device."""
        for name in names or self._pairs:
            h, d = self._pairs[name]
            d.copy_(h, non_blocking=True)

    def fill_sampling(self, sparams: Dict[str, np.ndarray],
                      any_sampled: bool) -> Tuple[str, ...]:
        """Copy the host slot parameters into the mirrors the step reads:
        rep_pen, and with any_sampled the sampling ones. Returns the names
        written, for upload()."""
        names = _sparam_names(any_sampled)
        for name in names:
            self.host[name][:] = sparams[name]
        return names

    def sparams(self, any_sampled: bool) -> Dict[str, torch.Tensor]:
        """The step's slot-parameter tensors: rep_pen, and with
        any_sampled the sampling ones."""
        return {name: getattr(self, name)
                for name in _sparam_names(any_sampled)}


class StepGraphs:
    """CUDA graphs of one engine's pure-decode step, one per static shape
    (key), in one shared memory pool. Held by the engine only, and
    holding nothing of it, so a dropped engine frees its graphs and their
    pool with its caches.

    The first `run` of a key warms the step up on a side stream, puts the
    recurrent state back as it was (attention-cache and `seen` writes
    are idempotent: the step writes the same rows again), then captures
    the step and replays it. Replays run the captured kernels on the same
    buffers in the same order as the eager step. Launch counts: the
    warm-up's launches are counted as they happen; the counts the
    wrappers add while capturing (nothing launches) are taken back, and
    each replay adds its capture's counts (`ops.add_launches`)."""

    def __init__(self, device: torch.device, n_slots: int):
        self.device = device
        self.n_slots = n_slots
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[tuple, tuple] = {}
        self._replays: Dict[tuple, int] = {}
        self.captures = 0
        self.capture_s = 0.0        # host seconds in warm-ups and captures
        self.replays = 0
        # the warm-ups' kernel launches, {kernel: n}
        self.warmup_launches = {k: 0 for k in kops.launch_counts()}

    def stats(self) -> Dict[str, object]:
        return {"captures": self.captures, "capture_s": self.capture_s,
                "replays": self.replays, "shapes": sorted(self._graphs),
                "replays_by_shape": dict(self._replays),
                "launches_per_replay": {
                    k: g[2] for k, g in sorted(self._graphs.items())},
                "warmup_launches": dict(self.warmup_launches)}

    def run(self, key: tuple, fn, caches, undo=None):
        """Replay the graph of `key`, capturing fn() first if it has none.
        undo: called after the warm-up, before the capture, to put back
        what the warm-up wrote and a replay would not write the same way.
        Returns the graph's static outputs (fn()'s result)."""
        entry = self._graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            entry = self._graphs[key] = self._capture(fn, caches, undo)
            torch.cuda.synchronize(self.device)
            self.capture_s += time.perf_counter() - t0
        graph, out, launches = entry
        graph.replay()
        kops.add_launches(launches)
        self.replays += 1
        self._replays[key] = self._replays.get(key, 0) + 1
        return out

    def _capture(self, fn, caches, undo):
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        slots = torch.arange(self.n_slots, device=dev)
        saved = save_recurrent(caches, slots)
        before = kops.launch_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
        restore_recurrent(caches, saved, slots)
        if undo is not None:
            undo()
        mid = kops.launch_counts()
        for k, n in mid.items():
            self.warmup_launches[k] += n - before[k]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        launches = {k: n - mid[k] for k, n in kops.launch_counts().items()}
        kops.add_launches({k: -n for k, n in launches.items()})
        self.captures += 1
        return graph, out, launches


class RoundBuffers:
    """The static device buffers of the speculative rounds: the round's
    inputs (`inputs`: t_0 as tokens (B, 1), pos, n_valid = caps + 1,
    rep_pen, the per-slot draft budgets `caps` and the post-verify
    restore's `starts`, with their pinned host mirrors), the seen table
    as the round found it (`seen_pre`: a verify capture's warm-up commits
    into the persistent table, and the capture puts it back from here),
    the draft's throwaway copy of the seen table, per draft length k the
    ring snapshot that the draft fills and the post-verify restore reads,
    and, once a sampled round runs at k, the draft distributions q_mat
    (B, k, V) f32 that the draft writes and the verify's rejection rule
    reads. Under a batch axis the inputs cover every slot and the rest
    the rank's `nb` rows."""

    def __init__(self, B: int, nb: int, V: int, device: torch.device):
        self.inputs = StepInputs(B, 1, device, extra=("caps", "starts"))
        self.seen_pre = torch.zeros((nb, V), dtype=torch.bool, device=device)
        self.draft_seen = torch.zeros((nb, V), dtype=torch.bool,
                                      device=device)
        self.snaps: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = {}
        self.q_mats: Dict[int, torch.Tensor] = {}

    def q_mat(self, k: int) -> torch.Tensor:
        """The static q_mat buffer of draft length k, made at first use."""
        if k not in self.q_mats:
            B, V = self.seen_pre.shape
            self.q_mats[k] = torch.zeros((B, k, V), dtype=torch.float32,
                                         device=self.seen_pre.device)
        return self.q_mats[k]


class Engine:
    """Serving engine over `n_slots` slots of `max_len` rows on
    `device` ("cuda" by default; raises without a card).
    prefill_chunk: prompt tokens a prefilling slot feeds per step;
    kv_buckets/kv_bucket_min: the power-of-two read-slice policy;
    prefix_cache: reuse shared prompt prefixes (retired requests stay
    matchable until evicted). paged: a page pool instead of contiguous
    slot caches; page_size: rows per page; n_pages: pool size (None = full
    capacity, n_slots full-length requests; smaller over-commits the
    slots, admission-limited); host_spill_pages: host tier for evicted
    prefix pages (0 = off). Recurrent and sliding-window plans prefill
    one token per step whatever prefill_chunk says. An encoder-decoder
    config (T5, whisper) is served by generate(..., encoder_frames=)
    only, as in the reference: submit() raises, and paged=True and
    speculative decoding refuse it. speculative: True or
    a SpecConfig turns on self-speculative decoding
    (serve/speculative.py); recurrent plans decode normally whatever it
    says. mesh: a DeviceMesh (launch/mesh.make_mesh) with a "model" dim,
    a "data" / "pod" dim or both, on the engine's device type; `params`
    are the FULL parameters, which the engine shards
    (sharding.shard_params). Every family serves over it, contiguous or
    paged. Steps (graph captures included) and
    generate() run without autograd, so trainable parameters (a
    Trainer's) serve as they are."""

    def __init__(self, cfg: ModelConfig, params, max_len: int, *,
                 n_slots: int = 8, mesh=None, prefill_chunk: int = 8,
                 kv_buckets: bool = True, kv_bucket_min: int = 32,
                 prefix_cache: bool = True,
                 speculative: Union[bool, SpecConfig] = False,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, host_spill_pages: int = 0,
                 device="cuda"):
        if kv_bucket_min < 1:
            raise ValueError(
                f"kv_bucket_min must be >= 1, got {kv_bucket_min}")
        if paged and page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if cfg.family == "encdec" and (paged or speculative):
            raise NotImplementedError(
                "paged caches and speculative decoding serve decoder-only "
                "families; an encoder-decoder model takes Engine(paged="
                "False, speculative=False).generate(..., encoder_frames=)")
        plan = layer_plan(cfg)
        self._has_recurrent = any(s.kind in ("rwkv", "mamba") for s in plan)
        # the capacity of every ring (sliding-window segment)
        self._ring_caps = tuple(min(max_len, s.window) for s in plan
                                if s.kind in ("attn", "shared_attn")
                                and s.window > 0)
        # segments whose caches are unstacked (the hybrid's shared block)
        self._shared = shared_segments(cfg)
        self._quantized = kv_quant_spec(cfg).quantized
        self.device = resolve_device(device)
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"parameters lie on {emb.device}, the engine "
                             f"on {self.device}")
        # gloo's collectives cannot be captured in a CUDA graph
        eager_mesh = self._check_mesh(cfg, mesh)
        if mesh is not None:
            params = sh.shard_params(params, cfg, mesh)
        self.cfg, self.params, self.mesh = cfg, params, mesh
        self.max_len = max_len
        self.n_slots = n_slots
        # the slots this rank holds, [lo, hi), of a batch axis
        self._lo, self._hi = sh.slot_range(n_slots, mesh)
        self._rows = slice(self._lo, self._hi)
        self._split = self._hi - self._lo < n_slots
        # the long-context layout: slots the batch axes do not divide,
        # contiguous caches split by rows (split_row_offsets makes the row
        # groups here, on every rank in the same order)
        self._seq = self._row_split = None
        if not paged and sh.rows_split(n_slots, mesh):
            self._seq = sh.SeqSplit(max_len)
            self._row_split = split_row_offsets(cfg, mesh, self._seq)
        # bytes a rank's pool sync sent in the last step (paged, split)
        self.last_sync_bytes = 0
        self._kv_buckets = kv_buckets
        self._kv_bucket_min = kv_bucket_min
        # recurrent state advances token by token, and a chunk's ring
        # writes would overwrite keys its earlier tokens still need:
        # chunk-1 prefill
        self._chunk = (1 if self._has_recurrent or self._ring_caps
                       else max(1, prefill_chunk))
        self._prefix_cache = prefix_cache
        self._paged = bool(paged)
        self._page_size = int(page_size)
        self._n_pages = n_pages
        self._host_spill_pages = int(host_spill_pages)
        self._sched: Optional[SlotScheduler] = None
        self._caches = None
        self._seen = None
        # the static step inputs, per chunk width, and the paged step's
        # block table (pinned host mirror, device buffer)
        self._inputs: Dict[int, StepInputs] = {}
        self._bt_host = self._bt = None
        self._bt_stale = True       # admit/retire changed the host table
        # on the card, pure-decode steps replay CUDA graphs
        self._use_graphs = self.device.type == "cuda" and not eager_mesh
        self._graphs = (StepGraphs(self.device, self._hi - self._lo)
                        if self._use_graphs else None)
        self._init_spec(speculative)
        self._events: List[Tuple[int, int]] = []      # last step's deltas
        # each live request's (2,) uint32 base key data, dropped at
        # retirement
        self._base_keys: Dict[int, np.ndarray] = {}
        # (B, n) chosen-token logprobs of the most recent generate() run
        # with sampling.logprobs=True; None otherwise
        self.last_logprobs = None
        # prefill/decode split: step time is attributed proportionally to
        # the tokens each phase consumed in that step. prefix_hits /
        # prefill_tokens_saved count prefix reuse (saved tokens arrived by
        # copy or aliasing instead of prefill); concurrency_peak is the
        # most slots active in one step
        # spec_* count the speculative rounds: drafted / accepted give the
        # accept rate, spec_k_sum / spec_rounds the mean draft length
        self.stats = {"steps": 0, "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "prefix_hits": 0, "prefill_tokens_saved": 0,
                      "spec_rounds": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_k_sum": 0,
                      "concurrency_peak": 0}

    def _init_spec(self, speculative: Union[bool, SpecConfig]) -> None:
        """Resolve the speculative mode against the plan, as the reference
        does at its first submit: recurrent plans fall back to normal
        decode (their state cannot rewind a rejected suffix), and ring
        plans cap the draft length so one round never wraps a ring row
        onto itself (k + 1 <= the smallest ring)."""
        if speculative is True:
            speculative = SpecConfig()
        elif speculative is False:
            speculative = None
        self._spec = False
        if speculative is None or self._has_recurrent:
            return
        k_cap = min(self._ring_caps) - 1 if self._ring_caps else None
        if k_cap is not None and k_cap < 1:
            return
        self._spec = True
        self._spec_k = AdaptiveK(speculative, k_cap)
        self._draft_layers = (speculative.draft_layers
                              if speculative.draft_layers is not None
                              else default_draft_layers(self.cfg))
        self._round: Optional[RoundBuffers] = None
        # the rounds' graphs: (draft, k, kv bucket, sampled), (verify, k,
        # kv bucket, logprobs, sampled), (restore, k)
        self._spec_graphs = (StepGraphs(self.device, self._hi - self._lo)
                             if self._use_graphs else None)

    def _check_mesh(self, cfg: ModelConfig, mesh) -> bool:
        """Refuse the meshes the engine does not serve: no "model" or batch
        dim, or another device type. Returns whether the mesh's
        collectives keep the steps eager on the card (a gloo group)."""
        if mesh is None:
            return False
        dims = [n for n in (mesh.mesh_dim_names or ())
                if n in (sh.MODEL,) + sh.BATCH]
        if not dims:
            raise ValueError(f"the engine's mesh needs a {sh.MODEL!r}, "
                             f"'data' or 'pod' dim, got "
                             f"{mesh.mesh_dim_names}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, the engine on "
                             f"{self.device}")
        return any(dist.get_backend(mesh.get_group(n)) == "gloo"
                   for n in dims)

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = type(self.stats[k])()

    @property
    def paged_stats(self) -> Optional[Dict[str, object]]:
        """Page-pool counters (None unless paged=True): occupancy,
        aliased vs fresh page acquisitions, and the spill tier's traffic.
        Lifetime counters, not reset by reset_stats."""
        if not self._paged or self._sched is None:
            return None
        pool = self._pool
        return {"page_size": pool.page, "n_pages": pool.n_pages,
                "pages_in_use": pool.pages_in_use,
                "pages_in_use_peak": pool.pages_in_use_peak,
                "alias_acquisitions": pool.alias_acquisitions,
                "fresh_acquisitions": pool.fresh_acquisitions,
                "page_share_rate": pool.page_share_rate,
                "spills": pool.spills, "restores": pool.restores,
                "host_dropped": pool.host_dropped,
                "host_pages_used": self._sched.host_pages_used}

    @property
    def graph_stats(self) -> Optional[Dict[str, object]]:
        """CUDA-graph counters (None off the card): captures, replays, the
        captured shapes (kv bucket, logprobs) and the replays of each,
        each shape's kernel launches a replay, and the warm-ups' launches.
        Over a gloo mesh on the card: captures 0 and why. Lifetime
        counters, not reset by reset_stats."""
        if self._graphs is None and self.device.type == "cuda":
            return {"captures": 0, "replays": 0,
                    "eager": "the mesh's gloo collectives cannot be "
                             "captured in a CUDA graph"}
        return None if self._graphs is None else self._graphs.stats()

    @property
    def spec_graph_stats(self) -> Optional[Dict[str, object]]:
        """The speculative rounds' graph counters, as graph_stats (None off
        the card or with speculative decoding off)."""
        if not self._spec or self._spec_graphs is None:
            return None
        return self._spec_graphs.stats()

    def _bucket(self, needed: int) -> int:
        if not self._kv_buckets:
            return self.max_len
        return kv_bucket(needed, self._kv_bucket_min, self.max_len)

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    # ------------------------------------------------------------------
    # continuous batching: submit / step / collect / stream
    # ------------------------------------------------------------------

    # The scheduler's hooks hold no reference to the engine: a bound
    # method would close a cycle engine -> scheduler -> engine, and a
    # dropped engine's device caches would then wait for Python's cyclic
    # collector instead of being freed at once.

    @staticmethod
    def _prefix_usable_len(p: int, depth: int, *, recurrent: bool,
                           ring_caps: Tuple[int, ...],
                           paged: bool = False) -> int:
        """Model-kind validity of a prefix match, contiguous or paged
        (scheduler hook, bound to the plan's `recurrent` flag and ring
        capacities and the layout; p is already capped to min(LCP, donor
        depth, prompt_len - 1)).

        * recurrent segments: the donor's state reflects ALL its `depth`
          fed tokens, so reuse is exact only when it stopped at the
          prefix boundary (depth == p). Paged, never: a retained entry
          owns only pages, and its slot's state was recycled at
          retirement.
        * ring segments (capacity W): a donor that decoded past the
          prefix overwrote ring rows the prefix still needs once it
          wraps; rows [max(0, p - W), p) survive iff depth <= max(p, W).
        """
        if p <= 0 or (recurrent and (paged or depth != p)):
            return 0
        if any(depth > max(p, W) for W in ring_caps):
            return 0
        return p

    def _ensure_slots(self):
        if self._sched is not None:
            return
        if self.cfg.family == "encdec":
            raise NotImplementedError(
                "continuous batching serves decoder-only families; "
                "use generate() for encoder-decoder models")
        usable = functools.partial(self._prefix_usable_len,
                                   recurrent=self._has_recurrent,
                                   ring_caps=self._ring_caps,
                                   paged=self._paged)
        if self._paged:
            P = self._page_size
            npages_max = -(-self.max_len // P)
            n_pages = (self._n_pages if self._n_pages is not None
                       else self.n_slots * npages_max)
            # the step writes this dict in place and never replaces it;
            # every batch rank holds the whole pool and its slots' state
            self._caches = init_paged_cache(
                self.cfg, self._hi - self._lo, self.max_len,
                n_pages=n_pages, page=P, device=self.device, mesh=self.mesh)
            self._pool = PagePool(n_pages, P, self.n_slots, self.max_len)
            self._sched = PagedScheduler(
                self.n_slots, self.max_len, pool=self._pool,
                prefix_cache=self._prefix_cache,
                prefix_usable_len=usable,
                # ring plans copy prefix pages instead of aliasing them: a
                # sharer's ring writes wrap back into its low pages, which
                # would overwrite the donor's shared rows
                alias_ok=not self._ring_caps,
                spill_fn=functools.partial(_spill_entry, self._caches, P),
                host_budget=self._host_spill_pages)
        else:
            self._sched = SlotScheduler(
                self.n_slots, self.max_len,
                prefix_cache=self._prefix_cache,
                prefix_usable_len=usable)
            self._caches = init_cache(self.cfg, self._hi - self._lo,
                                      self.max_len, device=self.device,
                                      mesh=self.mesh, seq=self._seq)
        self._seen = torch.zeros((self._hi - self._lo, self.cfg.vocab_size),
                                 dtype=torch.bool, device=self.device)

    def _local(self, slot: int) -> Optional[int]:
        """slot's index in this rank's caches and seen rows, or None when
        another data rank holds it."""
        return slot - self._lo if self._lo <= slot < self._hi else None

    def _copy_prefix(self, dst: int, src: int, p: int) -> None:
        """copy_prefix between global slots. Under a batch axis the two
        slots' owners may differ: the donor's rows (and, recurrent, its
        state) then move from its owner to the destination's by one
        broadcast a leaf within the batch group, which every rank of the
        group joins; no rank gathers whole caches."""
        kw = dict(copy_recurrent=self._has_recurrent, shared=self._shared,
                  split=self._row_split)
        if not self._split:
            copy_prefix(self._caches, dst, src, p, **kw)
            return
        nb = self._hi - self._lo
        owner_src, owner_dst = src // nb, dst // nb
        if owner_src == owner_dst:
            if self._local(dst) is not None:
                copy_prefix(self._caches, dst - self._lo, src - self._lo, p,
                            **kw)
            return
        ls, ld = self._local(src), self._local(dst)
        views = prefix_views(self._caches, 0 if ls is None else ls, p, **kw)
        dst_views = (prefix_views(self._caches, ld, p, **kw)
                     if ld is not None else [None] * len(views))
        for v, dv in zip(views, dst_views):
            buf = v.clone() if ls is not None else torch.empty_like(v)
            sh.batch_broadcast(buf, self.mesh, owner_src)
            if dv is not None:
                dv.copy_(buf)

    def _admit(self) -> None:
        """Admit queued requests and land each one's prefix rows, in
        admission order: an earlier admission may own (or be) a later
        one's source rows, and its copy must land first."""
        for st in self._sched.admit():
            self._bt_stale = True
            hit = st.prefix_len > 0
            if self._paged:
                # aliased pages need nothing: they ARE the donor's rows.
                # Fresh pages' scale rows are zeroed before any copy or
                # restore lands in them
                acts = st.paged or {}
                # the slot's recurrent state carries the previous request
                # (recurrent plans get no paged prefix hit); pool pages are
                # every rank's, and every rank changes them alike
                local = self._local(st.slot)
                if self._has_recurrent and local is not None:
                    reset_slot(self._caches, local, shared=self._shared)
                if self._quantized and acts.get("fresh"):
                    reset_pages(self._caches, acts["fresh"],
                                page=self._page_size)
                if "blob" in acts:
                    scatter_pages(self._caches, acts["blob"],
                                  acts["blob_dst"], page=self._page_size)
                elif "copy_src" in acts:
                    copy_pages(self._caches, acts["copy_dst"],
                               acts["copy_src"], page=self._page_size)
            else:
                # a recycled slot's recurrent state and quantized scales
                # carry the previous request: zero them, except on a
                # self-donor hit (src == dst), whose rows and state ARE
                # the prefix it reuses in place
                self_donor = hit and st.prefix_src == st.slot
                local = self._local(st.slot)
                if (self._has_recurrent or self._quantized) and \
                        not self_donor and local is not None:
                    reset_slot(self._caches, local, shared=self._shared)
                if hit:
                    self._copy_prefix(st.slot, st.prefix_src, st.prefix_len)
            # the seen row carries the previous occupant's tokens: clear
            # it (in place); a hit seeds it with the prefix ids, the row
            # cold prefill would have built
            local = self._local(st.slot)
            if local is not None:
                self._seen[local] = False
                if hit:
                    ids = self._tensor(np.asarray(
                        st.request.prompt[:st.prefix_len], np.int64))
                    self._seen[local, ids] = True
            if hit:
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += st.prefix_len
            self._sched.release_donor(st)

    def _refresh_block_table(self) -> None:
        """Bring the step's device block table `_bt`, one (n_slots,
        npages_max) int32 buffer for the engine's life, up to date before
        the step runs. Page assignments are static per request life, so
        the host table is copied into it only after admit() or retire()
        changed it."""
        if not self._bt_stale:
            return
        table = torch.from_numpy(self._pool.block_table())
        if self._bt is None:
            self._bt_host = torch.zeros(
                table.shape, dtype=table.dtype,
                pin_memory=self.device.type == "cuda")
            self._bt = torch.zeros_like(table, device=self.device)
        self._bt_host.copy_(table)
        self._bt.copy_(self._bt_host, non_blocking=True)
        self._bt_stale = False

    def submit(self, prompt, *, sampling: SamplingParams) -> int:
        """Enqueue one request. prompt: 1-D sequence of token ids. Returns
        a request id for collect()/stream(). sampling.seed=None seeds a
        sampled request by its request id."""
        if not isinstance(sampling, SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, got "
                            f"{type(sampling).__name__}")
        self._ensure_slots()
        prompt = np.asarray(prompt).reshape(-1).tolist()
        rid = self._sched.submit(prompt, sampling)
        seed = sampling.seed if sampling.seed is not None else rid
        self._base_keys[rid] = base_key_data(seed)
        return rid

    def _retire(self, st) -> None:
        self._sched.retire(st.slot)
        self._base_keys.pop(st.request.rid, None)
        self._bt_stale = True

    @torch.no_grad()
    def step(self) -> int:
        """One step: admit queued requests into free slots, advance every
        active slot (a chunk of prompt tokens while prefilling, one token
        while decoding), retire finished requests. The (rid, token) deltas
        sampled this step are exposed via stream(). Returns the number of
        slots that were active this step."""
        if self._sched is None:
            return 0
        self._admit()
        active = dict(self._sched.active)
        self._events = []
        if not active:
            return 0
        self.stats["concurrency_peak"] = max(
            self.stats["concurrency_peak"], len(active))
        if self._paged:
            self._refresh_block_table()
        # a speculative round only when EVERY active slot decodes: the
        # draft runs a cut layer stack, and a prefilling slot must fill
        # every layer's cache. A round in which no slot may draft (each at
        # its last token) falls through to the normal step
        if self._spec and not any(st.in_prefill for st in active.values()):
            n = self._spec_round(active)
            if n is not None:
                return n
        B = self.n_slots
        # pure-decode steps stay (B, 1); the chunk width only when a
        # prefilling slot can use it
        C = self._chunk if any(st.in_prefill for st in active.values()) \
            else 1
        inputs = self._inputs.get(C)
        if inputs is None:
            inputs = self._inputs[C] = StepInputs(B, C, self.device)
        h = inputs.host
        tokens, pos, nval = h["tokens"], h["pos"], h["nval"]
        tokens.fill(0)
        pos.fill(0)
        nval.fill(0)
        sparams = blank_slot_params(B)
        samples: Dict[int, bool] = {}
        want_lp = any_sampled = False
        pf_tokens = dec_tokens = 0
        needed = 1
        for slot, st in active.items():
            toks = st.next_tokens(C)
            n = len(toks)
            tokens[slot, :n] = toks
            pos[slot] = st.pos
            nval[slot] = n
            samples[slot] = st.samples_after(n)
            sp = st.request.sampling
            fill_slot_params(sparams, slot, sp,
                             self._base_keys[st.request.rid],
                             len(st.generated))
            want_lp |= sp.logprobs
            any_sampled |= not sp.greedy
            if st.in_prefill:
                pf_tokens += n
            else:
                dec_tokens += n
            needed = max(needed, st.pos + n)
        kv_len = self._bucket(needed)
        names = inputs.fill_sampling(sparams, any_sampled)
        t0 = serve_clock()
        inputs.upload("tokens", "pos", "nval", *names)
        # retained recurrent donors keep the state they retired with (a
        # paged retained entry owns pages, not a slot)
        kept = None
        if self._has_recurrent and not self._paged:
            mine = [s - self._lo for s in sorted(self._sched.retained)
                    if self._local(s) is not None]
            kept = self._tensor(np.asarray(mine, np.int64)) if mine else None
        saved = None if kept is None else save_recurrent(self._caches, kept)
        ids, lps = self._run_step(
            (kv_len, want_lp, any_sampled) if C == 1 else None,
            functools.partial(self._static_step, inputs, kv_len, want_lp,
                              any_sampled))
        if saved is not None:
            restore_recurrent(self._caches, saved, kept)
        ids = ids.cpu().numpy()               # (B,) — the only per-step
        lps = lps.cpu().numpy() if want_lp else None   # device->host pulls
        now = serve_clock()
        dt = now - t0
        total = max(pf_tokens + dec_tokens, 1)
        self.stats["steps"] += 1
        self.stats["prefill_tokens"] += pf_tokens
        self.stats["decode_tokens"] += dec_tokens
        self.stats["prefill_s"] += dt * pf_tokens / total
        self.stats["decode_s"] += dt * dec_tokens / total
        for slot, st in active.items():
            st.advance(int(nval[slot]))
            if not samples[slot]:
                continue
            tok = int(ids[slot])
            lp = (float(lps[slot])
                  if lps is not None and st.request.sampling.logprobs
                  else None)
            st.note_token(tok, lp, now=now)
            self._events.append((st.request.rid, tok))
            if st.should_retire():
                self._retire(st)
        return len(active)

    def _static_step(self, inputs: StepInputs, kv_len: int,
                     want_lp: bool, any_sampled: bool):
        """The step on the static buffers: decode_sample_step over
        `inputs`, the caches, `seen` and the block table buffer, all
        written in place. Returns (ids, logprobs | None) on the device.
        This is the function a CUDA graph captures. Under a batch axis it
        steps this rank's rows and all-gathers their ids (and logprobs)."""
        r = self._rows
        ids, lps, caches, seen = decode_sample_step(
            self.params, self._caches, self._seen, inputs.tokens[r],
            inputs.pos[r], inputs.nval[r], self._rows_of(
                inputs.sparams(any_sampled)),
            cfg=self.cfg, kv_len=kv_len, want_logprobs=want_lp,
            any_sampled=any_sampled, mesh=self.mesh, **self._step_kw())
        if caches is not self._caches or seen is not self._seen:
            raise RuntimeError("the step must write the caches and the seen "
                               "table in place")
        self._sync_pool(inputs.pos[r], inputs.nval[r], inputs.tokens.shape[1])
        return self._gather_rows(ids), self._gather_rows(lps)

    def _sync_pool(self, pos, nval, S: int) -> None:
        """Paged over a batch axis: send the rows this rank's slots wrote in
        a step of width S (pos, nval: its rows) to the other ranks and
        take theirs (decode.sync_pool), so every pool stays equal."""
        if not (self._paged and self._split):
            return
        kw = self._step_kw()
        rows = written_pool_rows(self.cfg, self._caches, kw["block_table"],
                                 self._page_size, pos, nval, S)
        self.last_sync_bytes = sync_pool(self._caches, rows, self.mesh,
                                         self._page_size)

    def _rows_of(self, tensors: Dict[str, torch.Tensor]):
        """This rank's rows of per-slot step tensors (views)."""
        return {name: t[self._rows] for name, t in tensors.items()}

    def _gather_rows(self, t: Optional[torch.Tensor]):
        """Every slot's rows of a per-slot result, all-gathered over the
        batch group when the rank holds only its own."""
        if t is None or not self._split:
            return t
        return sh.batch_all_gather(t, self.mesh)

    def _run_step(self, key: Optional[tuple], fn):
        """Run one step: on the card, a pure-decode step (key = its static
        shape) replays its CUDA graph; any other step calls fn()."""
        if key is None or self._graphs is None:
            return fn()
        return self._graphs.run(key, fn, self._caches)

    # ------------------------------------------------------------------
    # speculative rounds: draft, verify, ring rollback
    # ------------------------------------------------------------------

    def _spec_round(self, active) -> Optional[int]:
        """One speculative round (step()'s body when speculative mode is
        on and every active slot decodes). Returns the active-slot count,
        or None when no slot may draft (each slot's budget is 0); the
        caller then runs the normal step.

        On the card each phase replays a CUDA graph over static buffers:
        snapshot + draft + the pre-verify ring restore (one graph per k
        and kv bucket), the verify (per k, kv bucket and logprobs), the
        post-verify ring restore (per k). On the CPU the same functions
        are called directly. One device-to-host transfer a round: the
        committed tokens and counts (and the logprobs when asked for)."""
        B = self.n_slots
        # per-slot draft budget: the controller's k, clamped so the round
        # overruns neither max_new (it commits <= k_b + 1 tokens) nor the
        # slot's cache capacity
        caps: Dict[int, int] = {}
        for slot, st in active.items():
            rem = st.request.sampling.max_new - len(st.generated)
            caps[slot] = max(0, min(self._spec_k.k, rem - 1,
                                    self.max_len - 1 - st.pos))
        k = max(caps.values())
        if k < 1:
            return None
        S = k + 1
        if self._round is None:
            self._round = RoundBuffers(B, self._hi - self._lo,
                                       self.cfg.vocab_size, self.device)
        rb = self._round
        h = rb.inputs.host
        for name in ("tokens", "pos", "nval", "caps"):
            h[name].fill(0)
        sparams = blank_slot_params(B)
        want_lp = any_sampled = False
        needed = 1
        for slot, st in active.items():
            h["tokens"][slot, 0] = st.next_tokens(1)[0]
            h["pos"][slot] = st.pos
            h["nval"][slot] = caps[slot] + 1
            h["caps"][slot] = caps[slot]
            sp = st.request.sampling
            fill_slot_params(sparams, slot, sp,
                             self._base_keys[st.request.rid],
                             len(st.generated))
            want_lp |= sp.logprobs
            any_sampled |= not sp.greedy
            needed = max(needed, st.pos + caps[slot] + 1)
        names = rb.inputs.fill_sampling(sparams, any_sampled)
        # the draft and the verify read one kv bucket
        kv_len = self._bucket(needed)
        t0 = serve_clock()
        rb.inputs.upload("tokens", "pos", "nval", "caps", *names)
        ring = bool(self._ring_caps)
        if ring and k not in rb.snaps:
            # the static snapshot buffers of this k (their values unused)
            rb.snaps[k] = snapshot_rows(self.cfg, self._caches,
                                        rb.inputs.pos[self._rows], S,
                                        mesh=self.mesh, **self._step_kw())
        # 1. snapshot, draft k tokens, undo the draft's ring writes (the
        # verify chunk reads the pre-round window)
        tok_mat = self._run_round(
            ("draft", k, kv_len, any_sampled),
            functools.partial(self._static_draft, k, kv_len, any_sampled))
        # 2. the chunk verify and the accept rule; a capture's warm-up
        # committed into `seen` and wrote ring rows, which its replay
        # reads as the pre-round table and window, so both are put back
        # before the capture (its draws come from keys fixed by the
        # round's inputs and write nothing)
        out, lps = self._run_round(
            ("verify", k, kv_len, want_lp, any_sampled),
            functools.partial(self._static_verify, tok_mat, kv_len, want_lp,
                              any_sampled),
            undo=functools.partial(self._undo_verify, k))
        out = out.cpu().numpy()           # (B, S + 1): committed, count
        lps = lps.cpu().numpy() if want_lp else None
        now = serve_clock()
        dt = now - t0
        # 3. host commit: per-rid deltas in generation order, the finish
        # reasons checked token by token, so eos / stop may cut a round
        drafted = int(h["caps"].sum())
        accepted = committed = 0
        starts = h["starts"]
        starts.fill(S)
        for slot, st in active.items():
            m = int(out[slot, S])
            accepted += m - 1
            done_at = m
            for j in range(m):
                tok = int(out[slot, j])
                st.advance(1)
                lp = (float(lps[slot, j])
                      if lps is not None and st.request.sampling.logprobs
                      else None)
                st.note_token(tok, lp, now=now)
                self._events.append((st.request.rid, tok))
                if st.should_retire():
                    done_at = j + 1
                    break
            committed += done_at
            starts[slot] = done_at
            if st.finish_reason is not None:
                self._retire(st)
        # 4. ring rollback of every uncommitted row, rejected on the device
        # or cut on the host (eos mid-round), so a retained prefix donor
        # keeps a clean window
        if ring:
            rb.inputs.upload("starts")
            self._run_round(("restore", k),
                            functools.partial(self._static_restore, k, True))
        self._spec_k.update(accepted, drafted)
        self.stats["steps"] += 1
        self.stats["decode_tokens"] += committed
        self.stats["decode_s"] += dt
        self.stats["spec_rounds"] += 1
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        self.stats["spec_k_sum"] += k
        return len(active)

    def _step_kw(self) -> Dict[str, object]:
        """The step functions' layout arguments: this rank's rows of the
        block table, paged; the long-context layout, when it applies."""
        if self._paged:
            return {"block_table": self._bt[self._rows],
                    "page_size": self._page_size}
        return {} if self._seq is None else {"seq": self._seq}

    def _static_draft(self, k: int, kv_len: int,
                      any_sampled: bool) -> torch.Tensor:
        """Snapshot the round's ring rows into the static buffers of k and
        `seen` into seen_pre, draft k tokens (draft_round) on a throwaway
        copy of `seen`, then restore every snapshot row. A sampled round's
        draft also writes its distributions into the q_mat buffer of k.
        Returns tok_mat (B, k + 1) of the rank's rows (all slots but under
        a batch axis)."""
        rb = self._round
        inp = rb.inputs
        r = self._rows
        S = k + 1
        ring = bool(self._ring_caps)
        if ring:
            snapshot_rows(self.cfg, self._caches, inp.pos[r], S,
                          out=rb.snaps[k], mesh=self.mesh, **self._step_kw())
        rb.seen_pre.copy_(self._seen)
        rb.draft_seen.copy_(self._seen)
        tok_mat, _, _, _ = draft_round(
            self.params, self._caches, rb.draft_seen, inp.tokens[r],
            inp.pos[r], inp.caps[r], self._rows_of(inp.sparams(any_sampled)),
            cfg=self.cfg, draft_layers=self._draft_layers, k=k,
            kv_len=kv_len, any_sampled=any_sampled, mesh=self.mesh,
            q_out=rb.q_mat(k) if any_sampled else None, **self._step_kw())
        if ring:
            restore_rows(self.cfg, self._caches, rb.snaps[k], inp.pos[r], 0,
                         S, mesh=self.mesh, **self._step_kw())
        return tok_mat

    def _static_verify(self, tok_mat: torch.Tensor, kv_len: int,
                       want_lp: bool, any_sampled: bool):
        """The verify over the draft's tok_mat and, sampled, its q_mat
        (spec_verify_step), `seen` updated in place. Returns ((B, S + 1)
        int32: the committed tokens and, last, the committed count;
        logprobs (B, S) | None), every slot's: under a batch axis the
        rank's rows all-gathered, so every rank commits the same tokens and
        its AdaptiveK reads the same accept counts)."""
        rb = self._round
        inp = rb.inputs
        r = self._rows
        k = tok_mat.shape[1] - 1
        committed, n_comm, lps, _, _ = spec_verify_step(
            self.params, self._caches, self._seen, tok_mat, inp.pos[r],
            inp.nval[r], self._rows_of(inp.sparams(any_sampled)),
            rb.q_mat(k) if any_sampled else None, cfg=self.cfg,
            kv_len=kv_len, want_logprobs=want_lp, any_sampled=any_sampled,
            mesh=self.mesh, **self._step_kw())
        out = torch.cat([committed, n_comm[:, None].to(torch.int32)], dim=1)
        if not self._ring_caps:
            self._sync_pool(inp.pos[r], inp.nval[r], k + 1)
        return self._gather_rows(out), self._gather_rows(lps)

    def _static_restore(self, k: int, from_starts: bool) -> None:
        """Restore the round's ring rows from the snapshot buffers of k:
        each slot's rows from its `starts` entry on (the post-verify
        rollback, which ends a ring plan's round: paged over a batch axis,
        the round's rows are then sent to the other ranks), or all of
        them."""
        inp = self._round.inputs
        r = self._rows
        restore_rows(self.cfg, self._caches, self._round.snaps[k], inp.pos[r],
                     inp.starts[r] if from_starts else 0, k + 1,
                     mesh=self.mesh, **self._step_kw())
        if from_starts:
            self._sync_pool(inp.pos[r], inp.nval[r], k + 1)

    def _undo_verify(self, k: int) -> None:
        """Put back what a verify capture's warm-up wrote that its replay
        would read: the committed prefix in `seen` (from seen_pre) and,
        on ring plans, every ring row of the round."""
        self._seen.copy_(self._round.seen_pre)
        if self._ring_caps:
            self._static_restore(k, False)

    def _run_round(self, key: tuple, fn, undo=None):
        """Run one phase of a round: on the card, replay the graph of
        `key` (captured at its first use); on the CPU, call fn()."""
        if self._spec_graphs is None:
            return fn()
        return self._spec_graphs.run(key, fn, self._caches, undo=undo)

    def stream(self) -> Iterator[Tuple[int, int]]:
        """Drive step() while work remains, yielding (rid, token) deltas
        as each step completes. Finished requests remain collectable via
        collect()."""
        self._ensure_slots()
        while self._sched.has_work:
            self.step()
            yield from self._events

    def _completion(self, st) -> Completion:
        r = st.request
        return Completion(
            rid=r.rid, tokens=tuple(st.generated),
            finish_reason=st.finish_reason or "length",
            prompt_len=len(r.prompt),
            prefix_len=st.prefix_len,
            logprobs=(tuple(st.logprobs) if r.sampling.logprobs else None),
            submitted_at=r.arrival, first_token_at=st.t_first,
            finished_at=st.t_done)

    def collect(self, rid: Optional[int] = None):
        """Pop finished results as typed Completions. With rid: that
        request's Completion (None if not finished). Without: {rid:
        Completion} for every finished request."""
        if self._sched is None:
            return None if rid is not None else {}
        if rid is not None:
            st = self._sched.pop_finished(rid)
            return None if st is None else self._completion(st)
        return {r: self._completion(st)
                for r, st in self._sched.pop_finished().items()}

    def run(self, max_steps: int = 100_000) -> Dict[int, Completion]:
        """Drive step() until queue + slots drain; returns collect().
        Raises if max_steps is exhausted with work still pending."""
        self._ensure_slots()
        for _ in range(max_steps):
            if not self._sched.has_work:
                break
            self.step()
        if self._sched.has_work:
            raise RuntimeError(
                f"run() exhausted max_steps={max_steps} with "
                f"{len(self._sched.active)} active and "
                f"{self._sched.n_queued} queued requests remaining")
        return self.collect()

    @property
    def has_work(self) -> bool:
        return self._sched is not None and self._sched.has_work

    # ------------------------------------------------------------------
    # static batch (oracle) — same sampler as the continuous step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt_tokens, n_new: Optional[int] = None, *,
                 sampling: Optional[SamplingParams] = None,
                 temperature: float = 0.0, key=None,
                 encoder_frames=None) -> torch.Tensor:
        """prompt_tokens: (B, S). Returns (B, n) generated ids (int32, on
        the engine's device), through contiguous caches of its own even
        when the engine is paged. encoder_frames: an encoder-decoder
        model's encoder input, int token ids (B, S_enc) for T5 or float
        frame embeddings (B, S_enc, d) for whisper, as in the reference;
        prefill encodes it once and fills the cross-attention caches.

        generate(prompts, sampling=SamplingParams(...)): row b samples
        under base key jax.random.key(sampling.seed + b) (seed defaults to
        0), folded by token index, through the same sample_rows as the
        continuous path; n defaults to sampling.max_new, and an explicit
        n_new is capped at it. The legacy form generate(prompts, n_new,
        temperature=, key=): key=None means greedy; with key (the (2,)
        uint32 data of a JAX key, serve/sampling.key_data_of), row b uses
        fold_in(key, b) as its base key. Passing both forms raises
        TypeError. The static batch always emits the full n tokens per
        row; eos/stops are scheduler concerns, so a seeded B=1 call's
        stream is what a continuous request with the same SamplingParams
        returns a prefix of. Under a batch axis whose size divides B each
        rank runs its rows (sharding.slot_range) and the tokens (and
        logprobs) are all-gathered: every rank returns all B rows; one
        that does not divide B runs every row on every rank with the
        caches in the long-context layout (sharding.SeqSplit)."""
        cfg = self.cfg
        prompt_tokens = self._tensor(prompt_tokens).to(torch.long)
        B, S = prompt_tokens.shape
        if sampling is None:
            if n_new is None:
                raise TypeError("generate() needs n_new or sampling=")
            sampled = temperature > 0.0 and key is not None
            sampling = SamplingParams(
                max_new=int(n_new),
                temperature=float(temperature) if sampled else 0.0)
            keys = np.zeros((B, prng.KEY_WIDTH), np.int64)
            if sampled:
                base = prng.as_key_data(key_data_of(key))
                keys = prng.fold_in(base.expand(B, prng.KEY_WIDTH),
                                    torch.arange(B)).numpy()
        elif key is not None or temperature != 0.0:
            raise TypeError(
                "pass either sampling=SamplingParams(...) or the legacy "
                "(temperature, key) kwargs — not both")
        else:
            seed = sampling.seed if sampling.seed is not None else 0
            keys = np.stack([base_key_data(seed + b) for b in range(B)])
            if n_new is not None:
                n_new = min(int(n_new), sampling.max_new)
        n = int(n_new) if n_new is not None else sampling.max_new
        if S + n > self.max_len:
            raise ValueError(f"prompt({S}) + n({n}) exceeds "
                             f"max_len={self.max_len}")
        any_sampled = not sampling.greedy
        sparams = blank_slot_params(B)
        for b in range(B):
            fill_slot_params(sparams, b, sampling, keys[b], 0)
        sparams["key"] = sparams["key"].astype(np.int64)
        lo, hi = sh.slot_range(B, self.mesh)
        # rows the batch axes do not divide: the long-context layout
        seq = (sh.SeqSplit(self.max_len) if sh.rows_split(B, self.mesh)
               else None)
        sp_dev = {name: self._tensor(v[lo:hi]) for name, v in sparams.items()}
        prompt_tokens = prompt_tokens[lo:hi]
        want_lp = sampling.logprobs
        seen = torch.zeros((hi - lo, cfg.vocab_size), dtype=torch.bool,
                           device=self.device)

        def step_fn(p, c, tk, t):
            return decode_step(p, cfg, c, tk, t, kv_len=self._bucket(t + 1),
                               mesh=self.mesh, seq=seq)

        if encoder_frames is not None:
            encoder_frames = self._tensor(encoder_frames)[lo:hi]
        logits, caches = prefill(self.params, cfg, prompt_tokens,
                                 T=self.max_len, step_fn=step_fn,
                                 encoder_frames=encoder_frames,
                                 mesh=self.mesh, seq=seq)
        update_seen(seen, prompt_tokens)
        outs, lp_outs = [], []

        def sample_at(logits, t):
            rows = logits[:, -1, :cfg.vocab_size]
            sp_dev["sample_idx"].fill_(t)
            return sample_rows(rows, sp_dev, seen, want_logprobs=want_lp,
                               any_sampled=any_sampled)

        tok, lp = sample_at(logits, 0)
        outs.append(tok)
        lp_outs.append(lp)
        for t in range(1, n):
            tk = tok[:, None].to(torch.long)
            logits, caches = decode_step(self.params, cfg, caches, tk,
                                         S + t - 1,
                                         kv_len=self._bucket(S + t),
                                         mesh=self.mesh, seq=seq)
            update_seen(seen, tk)
            tok, lp = sample_at(logits, t)
            outs.append(tok)
            lp_outs.append(lp)
        def whole(t):
            return t if hi - lo == B else sh.batch_all_gather(t, self.mesh)
        self.last_logprobs = (whole(torch.stack(lp_outs, dim=1)) if want_lp
                              else None)
        return whole(torch.stack(outs, dim=1))
