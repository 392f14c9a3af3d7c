"""Serving engine: continuous batching + prefix cache + paged KV pool.

Port of ``repro.serving.engine`` for the attention families (KV caching)
and rwkv6 (state snapshots):
  * a fixed pool of ``max_seqs`` dense decode slots (the closed-loop MPL N —
    exactly the paper's multiprogramming limit);
  * a host-side **controller**: prefix-cache lookup/insert under a
    pluggable eviction policy, page allocator, slot scheduler.  Every
    controller action's metadata ops are recorded — these are the paper's
    serialized queue-station visits;
  * admission: chunk the prompt, gather prefix-cache hit pages into the
    slot's dense cache (attention) or restore a state snapshot (rwkv6),
    prefill only the uncached remainder, then insert the newly computed
    chunks (or the snapshot) into the cache;
  * decode: one batched step over every slot per engine tick (idle slots
    too, as in the reference);
  * bypass (paper §5.2 mitigation): a fraction of requests skip the
    controller entirely.

As in the reference, attention in the engine reaches no Pallas kernel:
prefill and decode run with a KV cache, so attention is
``chunked_attention``.  An rwkv6 engine runs the WKV kernel in every
prefill and decode.  Caches and the pool are updated in place.

The state snapshot is keyed, as in the reference, by the hash of the
prompt up to its last *full* page, but holds the state after
``len(prompt) - 1`` tokens: a later prompt that shares those pages and not
the tail restores another prompt's tail (ROADMAP queue 3).  The port
reproduces it.

``ServeConfig.sketch_cap > 0`` feeds the admission stream, one event per
looked-up chunk, to an exact-counting
:class:`~repro_torch.obs.streaming.PyStreamSketch`, as the reference does:
:meth:`Engine.telemetry` then carries its summary and alarms, and
:meth:`Engine.observed_profile` recovers a measured profile from it.

Not ported yet, and raising ``NotImplementedError``: mamba2 and its
hybrids (ROADMAP queue 1 item 13).  The cluster forecast ``n_shards > 1``
and the hierarchy forecast ``tiers > 0`` compose their networks as the
reference does (:mod:`repro_torch.cluster`, :mod:`repro_torch.hierarchy`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.streaming import PyStreamSketch
from repro_torch.serving import kv_pages
from repro_torch.serving.kv_pages import KVPool, PageAllocator
from repro_torch.serving.prefix_cache import PrefixCache, chunk_hashes


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seqs: int = 4  # MPL (decode slots)
    max_seq_len: int = 256
    page_size: int = 16  # tokens per KV page / prefix chunk
    n_pages: int = 64
    prefix_capacity: int = 48  # policy capacity (pages)
    policy: str = "lru"
    bypass_fraction: float = 0.0
    max_new_tokens: int = 16
    seed: int = 0
    # Closed-loop forecast knobs (paper Sec. 6 "future systems"): the pod's
    # physical core count drives the controller's effective MPL in the p*
    # forecast, and disk_servers > 0 models the backing store / prefill
    # path as a bounded-concurrency queue station instead of the paper's
    # infinite-server disk.  n_shards > 1 lifts the p* forecast to a
    # hash-routed cluster of n_shards identical pods (Engine.forecast_network):
    # per-shard station replicas, cluster-level p*.
    cores: int = 72
    disk_servers: int = 0
    n_shards: int = 1
    # Streaming-observability knobs (repro_torch.obs.streaming):
    # sketch_cap > 0 threads the exact-counting PyStreamSketch through
    # admission — every looked-up chunk hash feeds the popularity estimator
    # and its hit / miss outcome feeds the windowed + EWMA hit estimators,
    # with ``sketch_window_ticks`` engine ticks per tumbling window (the
    # engine's clock is ticks, so decoded rates are per tick).  0 keeps
    # admission sketch-free.
    sketch_cap: int = 0
    sketch_window_ticks: int = 64


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt
    max_new: int
    out: Optional[List[int]] = None
    slot: int = -1
    done: bool = False
    prefill_tokens_computed: int = 0
    prefill_tokens_skipped: int = 0


class Engine:
    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        if cfg.encdec:
            raise ValueError("enc-dec archs are served via examples/, not Engine")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.state_mode = cfg.block in ("rwkv6", "mamba2")  # snapshot caching

        self.caches = transformer.init_cache(
            cfg, serve.max_seqs, serve.max_seq_len, device=self.device)
        self.pool = [tuple(self._pool_entry(c) for c in stage)
                     for stage in self.caches]
        self.allocator = PageAllocator(serve.n_pages)
        self.prefix = PrefixCache(
            self.allocator, serve.prefix_capacity, policy=serve.policy)
        self.lengths = np.zeros(serve.max_seqs, dtype=np.int64)
        self.active: Dict[int, Request] = {}  # slot -> request
        self.free_slots = list(range(serve.max_seqs))
        self.waiting: List[Request] = []
        self._rng = np.random.default_rng(serve.seed)
        self.ticks = 0
        self.decode_steps = 0
        self.metrics = Metrics()
        self._sketch = None
        if serve.sketch_cap:
            # branch 0 = chunk hit, branch 1 = chunk miss
            self._sketch = PyStreamSketch(
                serve.sketch_cap, n_branches=2,
                window_us=float(serve.sketch_window_ticks))

    def _forward(self, tokens, caches, cache_len):
        logits, caches, _ = transformer.forward(
            self.params, tokens, self.cfg, caches=caches, cache_len=cache_len,
            device=self.device)
        return logits, caches

    def _pool_entry(self, c):
        """The pool of one cache entry: K/V pages for a :class:`KVCache`,
        one snapshot per page of every leaf of a recurrent state."""
        n, ps = self.serve.n_pages, self.serve.page_size
        if isinstance(c, KVCache):
            return KVPool(kv_pages.make_kv_pool_leaf(c.k, n, ps),
                          kv_pages.make_kv_pool_leaf(c.v, n, ps))
        return type(c)(*(kv_pages.make_kv_pool_leaf(leaf, n, ps, is_kv=False)
                         for leaf in c))

    def layer_pools(self):
        """Each attention layer's ``(P, page, KV, dh)`` K and V pools, in
        layer order (none for a recurrent model)."""
        out = []
        for si, (g, pattern) in enumerate(transformer.build_stages(self.cfg)):
            for li in range(g):
                out.extend((pool.k[li], pool.v[li]) for pool in self.pool[si]
                           if isinstance(pool, KVPool))
        return out

    # ------------------------------------------------------------- admission
    def submit(self, tokens, max_new: Optional[int] = None, rid: Optional[int] = None):
        r = Request(
            rid=len(self.waiting) if rid is None else rid,
            tokens=np.asarray(tokens, dtype=np.int64),
            max_new=max_new or self.serve.max_new_tokens,
        )
        self.waiting.append(r)
        return r

    def _slot_cache(self):
        """Fresh single-sequence cache for a prefill."""
        return transformer.init_cache(self.cfg, 1, self.serve.max_seq_len,
                                      device=self.device)

    def _admit(self, r: Request, slot: int) -> None:
        ps = self.serve.page_size
        bypass = self._rng.random() < self.serve.bypass_fraction
        hashes = [] if bypass else chunk_hashes(r.tokens, ps)
        if bypass:
            self.prefix.stats.bypassed += 1

        cache1 = self._slot_cache()

        if self.state_mode:
            logits, cache1, r_stats = self._admit_state(r, cache1, hashes)
            r.prefill_tokens_skipped, r.prefill_tokens_computed = r_stats
        else:
            n_hit = 0
            if hashes:
                pages, n_hit = self.prefix.lookup(hashes)
                if n_hit:
                    self._gather(cache1, pages)

            start = n_hit * ps
            remainder = r.tokens[start:]
            r.prefill_tokens_skipped = start
            r.prefill_tokens_computed = len(remainder)
            if len(remainder) == 0:  # full hit: re-prefill the last token
                # (idempotent for KV caches: position len-1 is overwritten
                # with identical values)
                remainder = r.tokens[-1:]
                start = len(r.tokens) - 1
                r.prefill_tokens_computed = 1

            if n_hit:
                self._set_index(cache1, start)
            logits, cache1 = self._forward(self._tokens(remainder), cache1,
                                           [start])

            # insert newly computed full chunks into the prefix cache
            if hashes:
                n_full = len(r.tokens) // ps
                for i in range(n_hit, n_full):
                    page = self.prefix.insert(hashes[i], self._rng.random())
                    if page is not None:
                        self._store_chunk(cache1, i * ps, page)

        if self._sketch is not None and hashes:
            # one stream event per looked-up chunk: the hash is the
            # popularity key, skipped tokens mark it a hit (bypassed
            # requests never reach the controller, so never the stream)
            t = float(self.ticks)
            n_hit_chunks = r.prefill_tokens_skipped // ps
            for i, h in enumerate(hashes):
                self._sketch.arrival(t)
                self._sketch.key(h)
                self._sketch.done(t, 0 if i < n_hit_chunks else 1,
                                  is_hit=i < n_hit_chunks)

        self._install(cache1, slot)
        self.lengths[slot] = len(r.tokens)
        first = int(logits[0, -1].argmax())
        r.out = [first]
        r.slot = slot
        self.active[slot] = r
        self.metrics.count("admissions_count")
        self.metrics.count("prefill_tokens_computed_count",
                           r.prefill_tokens_computed)
        self.metrics.count("prefill_tokens_skipped_count",
                           r.prefill_tokens_skipped)
        self.metrics.observe(
            "prefill_hit_frac",
            r.prefill_tokens_skipped
            / max(r.prefill_tokens_skipped + r.prefill_tokens_computed, 1),
        )

    def _tokens(self, toks) -> torch.Tensor:
        """A prompt slice as a (1, T) int32 tensor on the engine's device."""
        return torch.as_tensor(toks, dtype=torch.int32,
                               device=self.device)[None, :]

    def _admit_state(self, r: Request, cache1, hashes):
        """Recurrent-state admission: all-or-nothing snapshot of the state
        at len(prompt)-1, keyed by the last full page's hash; the final
        prompt token is always prefilled fresh (state updates are not
        idempotent, unlike KV writes).  Returns ``(logits, cache1,
        (skipped, computed))``."""
        full = hashes[-1] if hashes else None
        hit = full is not None and full in self.prefix.pages

        if hit:
            pages, _ = self.prefix.lookup([full])
            self._restore_state(cache1, pages[0])
            start = len(r.tokens) - 1
            logits, cache1 = self._forward(self._tokens(r.tokens[-1:]),
                                           cache1, [start])
            return logits, cache1, (len(r.tokens) - 1, 1)

        if full is not None:
            self.prefix.stats.chunk_misses += 1
        head, last = r.tokens[:-1], r.tokens[-1:]
        if len(head):
            _, cache1 = self._forward(self._tokens(head), cache1, [0])
        if full is not None:  # snapshot the state at len-1
            page = self.prefix.insert(full, self._rng.random())
            if page is not None:
                self._store_state(cache1, page)
        logits, cache1 = self._forward(self._tokens(last), cache1, [len(head)])
        return logits, cache1, (0, len(r.tokens))

    # ------------------------------------------------ cache <-> pool plumbing
    def _entries(self, cache1, kv: bool):
        """(pool entry, cache entry) pairs of K/V pools (``kv``) or of
        recurrent-state snapshots (not ``kv``)."""
        for pstage, cstage in zip(self.pool, cache1):
            for pool, c in zip(pstage, cstage):
                if isinstance(pool, KVPool) == kv:
                    yield pool, c

    def _gather(self, cache1, pages: List[int]) -> None:
        for pool, c in self._entries(cache1, kv=True):
            kv_pages.gather_pages(c.k, pool.k, 0, pages)
            kv_pages.gather_pages(c.v, pool.v, 0, pages)

    def _store_chunk(self, cache1, start: int, page_id: int) -> None:
        for pool, c in self._entries(cache1, kv=True):
            kv_pages.store_chunk(pool.k, c.k, 0, start, page_id)
            kv_pages.store_chunk(pool.v, c.v, 0, start, page_id)

    def _store_state(self, cache1, page_id: int) -> None:
        for pool, c in self._entries(cache1, kv=False):
            for p_leaf, c_leaf in zip(pool, c):
                kv_pages.store_state(p_leaf, c_leaf, 0, page_id)

    def _restore_state(self, cache1, page_id: int) -> None:
        for pool, c in self._entries(cache1, kv=False):
            for p_leaf, c_leaf in zip(pool, c):
                kv_pages.restore_state(c_leaf, p_leaf, 0, page_id)

    @staticmethod
    def _set_index(cache1, value: int) -> None:
        for stage in cache1:
            for c in stage:
                c.index.fill_(value)

    def _install(self, cache1, slot: int) -> None:
        """Copy every leaf of the one-sequence cache (the index, or a
        recurrent state, too) into ``slot`` of the batch caches."""
        for bstage, sstage in zip(self.caches, cache1):
            for bc, sc in zip(bstage, sstage):
                for b_leaf, s_leaf in zip(bc, sc):
                    b_leaf[:, slot] = s_leaf[:, 0]

    # ------------------------------------------------------------------ tick
    def tick(self) -> bool:
        """Admit waiting requests, run one batched decode step.
        Returns True while work remains."""
        self.ticks += 1
        self.metrics.count("ticks_count")
        while self.waiting and self.free_slots:
            slot = self.free_slots.pop()
            self._admit(self.waiting.pop(0), slot)
        self.metrics.gauge("active_slots_count", len(self.active))
        self.metrics.gauge("waiting_count", len(self.waiting))
        self.metrics.gauge("pages_free_count", self.allocator.n_free)

        if not self.active:
            return bool(self.waiting)
        self.metrics.observe("decode_batch_count", len(self.active))

        B = self.serve.max_seqs
        tokens = np.zeros((B, 1), dtype=np.int32)
        for slot, r in self.active.items():
            tokens[slot, 0] = r.out[-1]
        logits, self.caches = self._forward(
            torch.from_numpy(tokens).to(self.device), self.caches,
            torch.from_numpy(self.lengths.astype(np.int32)).to(self.device))
        self.decode_steps += 1
        self.metrics.count("decode_steps_count")
        self.metrics.count("decode_tokens_count", len(self.active))
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()

        finished = []
        for slot, r in list(self.active.items()):
            self.lengths[slot] += 1
            if len(r.out) >= r.max_new:
                r.done = True
                finished.append(slot)
            else:
                r.out.append(int(nxt[slot]))
        for slot in finished:
            del self.active[slot]
            self.free_slots.append(slot)
            self.lengths[slot] = 0
        if finished:
            self.metrics.count("completions_count", len(finished))
        return bool(self.active or self.waiting)

    def run(self, max_ticks: int = 10_000):
        while self.tick():
            if self.ticks >= max_ticks:
                raise RuntimeError("engine did not drain")
        return self.stats()

    def stats(self) -> dict:
        s = self.prefix.stats
        return {
            "decode_steps": self.decode_steps,
            "chunk_hit_ratio": s.hit_ratio,
            "controller_ops": s.ops.tolist(),
            "evictions": s.evictions,
            "bypassed": s.bypassed,
            "pages_free": self.allocator.n_free,
        }

    def telemetry(self) -> dict:
        """Full observability snapshot: the per-tick metric registry
        (counters / gauges / distribution sketches, unit-suffixed names —
        see :mod:`repro_torch.obs.metrics`) alongside :meth:`stats`.  With
        ``ServeConfig.sketch_cap > 0`` the snapshot additionally carries
        a ``"streaming"`` summary of the admission-stream estimators and
        a ``"alarms"`` list (phase-change drift on the windowed chunk
        hit fraction, sketch-saturation pressure)."""
        out = {"metrics": self.metrics.snapshot(), "stats": self.stats()}
        if self._sketch is not None:
            est = self._sketch.estimates()
            keys, counts, _ = est.topk(8)
            out["streaming"] = {
                "window_ticks": self._sketch.window_us,
                "window_id": est.window_id.tolist(),
                "win_hit_frac": est.win_hit_frac.tolist(),
                "win_done_rate_per_tick": est.win_done_rate.tolist(),
                "win_arrival_rate_per_tick": est.win_arrival_rate.tolist(),
                "ewma_hit_frac": est.ewma_hit_frac,
                "ewma_delayed_frac": est.ewma_delayed_frac,
                "key_count": est.key_count,
                "saturation_frac": est.saturation_frac(),
                "topk_key": keys.tolist(),
                "topk_count": counts.tolist(),
            }
            out["alarms"] = self._stream_alarms(est)
        return out

    def _stream_alarms(self, est) -> list:
        """Drift alarms over the decoded admission-stream estimates:
        a Page-Hinkley scan over the windowed chunk hit fraction flags
        phase changes; SpaceSaving pressure past 5% flags saturation."""
        from repro_torch.obs.drift import page_hinkley_scan

        alarms = []
        ok = np.isfinite(est.win_hit_frac)
        hit, wid = est.win_hit_frac[ok], est.window_id[ok]
        for i in page_hinkley_scan(hit, warmup=4):
            alarms.append({
                "kind": "phase-change", "window_id": int(wid[i]),
                "measured": float(hit[i]),
                "detail": "windowed chunk hit fraction drifted",
            })
        sat = est.saturation_frac()
        if sat > 0.05:
            alarms.append({
                "kind": "sketch-saturation",
                "window_id": int(est.window_id[-1])
                if len(est.window_id) else -1,
                "measured": sat,
                "detail": "SpaceSaving table thrashing; raise sketch_cap",
            })
        return alarms

    def observed_profile(self, caps=None):
        """Online measured profile of this engine's chunk stream,
        recovered with no Mattson sweep.  Returns a
        :class:`repro_torch.obs.profile.ObservedProfile`: estimated chunk-
        popularity masses (over the observed chunk hashes) fed through
        the Che approximation into a cap → hit-ratio curve, alongside
        the measured EWMA hit / delayed fractions.  ``caps`` overrides
        the capacity grid (pages); pass ``ServeConfig.prefix_capacity``
        neighbourhoods to ask "would a bigger prefix cache pay off".
        Requires ``ServeConfig.sketch_cap > 0``."""
        if self._sketch is None:
            raise ValueError(
                "observed_profile needs ServeConfig.sketch_cap > 0")
        from repro_torch.obs.profile import observed_profile

        return observed_profile(self._sketch.estimates(), key_space=None,
                                caps=caps)

    def forecast_slo(self, step_us: float, prefill_us: float,
                     arrival_rate: float, slo_us: float,
                     percentile: float = 0.99, p_grid=None,
                     profile=None, **net_kwargs):
        """Open-loop SLO forecast for this engine's prefix controller.

        Builds the same measured-profile network as
        :meth:`forecast_network` (all of whose kwargs pass through), then
        evaluates it under Poisson arrivals at ``arrival_rate`` requests/µs
        via :func:`repro_torch.latency.slo_forecast`: mean and
        ``percentile`` tail response across the hit-ratio grid, the
        stability boundary lambda_max(p), and the three operating points —
        throughput-optimal p* (the closed-loop knee), latency-optimal p* at
        the offered rate, and SLO-capacity-optimal p* (argmax of the
        largest arrival rate whose tail still meets ``slo_us``).

        ``profile`` (default: this engine's :meth:`observed_profile` when
        ``ServeConfig.sketch_cap > 0`` and the sketch holds keys)
        restricts the sweep to the measured achievable hit-ratio range and
        annotates each grid point with the prefix-cache capacity achieving
        it.
        """
        from repro_torch.latency import slo_forecast

        if profile is None and self._sketch is not None \
                and self._sketch.key_count > 0:
            profile = self.observed_profile()
        net = self.forecast_network(step_us, prefill_us, **net_kwargs)
        return slo_forecast(net, arrival_rate, slo_us,
                            percentile=percentile, p_grid=p_grid,
                            profile=profile)

    def forecast_network(self, step_us: float, prefill_us: float,
                         replicas: int = 1, batched_update: bool = False,
                         cores: int | None = None,
                         coalesce_flows: int = 0,
                         n_shards: int | None = None,
                         shard_profile=None,
                         tiers: int = 0,
                         tier_profile=None):
        """Closed-network p* forecast for this engine's prefix controller,
        for one pod.

        Uses the measured controller op profile plus the ServeConfig
        deployment knobs: the effective MPL is ``replicas * cores`` (one
        closed-loop client per physical core), and ``disk_servers`` bounds
        the chunk-prefill concurrency when > 0.  ``batched_update`` models
        the batched LRU sweep (promotions coalesce, so per-access
        delink/head demand divides by the MPL).  ``cores`` overrides
        ``ServeConfig.cores``.  ``coalesce_flows > 0`` models prefill
        deduplication over that many hot chunks, via
        :func:`repro_torch.core.queueing.coalesced_network` with the
        prefill latency as the in-flight window.

        ``n_shards`` (default ``ServeConfig.n_shards``) > 1 lifts the
        measured-profile network to a hash-routed cluster of identical
        pods via :func:`repro_torch.cluster.compose_cluster` and returns
        the composed cluster network — per-shard station replicas, cluster
        MPL ``n_shards * replicas * cores``, cluster-level p*.
        ``shard_profile`` (a :class:`repro_torch.cluster.ShardProfile`)
        supplies routing skew + per-shard local hit ratios; the default is
        a perfectly balanced homogeneous cluster.  ``coalesce_flows`` and
        ``n_shards > 1`` compose: the cluster network is built first and
        :func:`repro_torch.core.queueing.coalesced_network` then solves one
        shard-local sigma_k per ``sK:disk``.

        ``tiers > 0`` composes a two-tier hierarchy of this pod's network
        via :func:`repro_torch.hierarchy.compose_tiers`: ``tiers`` L1
        client instances in front of ``max(n_shards, 1)`` L2 shards, the
        prefill recompute as the origin, MPL ``replicas * cores * tiers``.
        ``tier_profile`` (a :class:`repro_torch.hierarchy.TieredProfile`)
        maps the global knob to the tiers' hit ratios; the default is a
        constant L2 hit ratio of 0.5 on balanced shards.  With
        ``coalesce_flows`` the cross-tier transform
        :func:`repro_torch.hierarchy.coalesced_hierarchy` is returned.
        """
        from repro_torch.core.harness import PAPER_SERVICES, ServiceTimes
        from repro_torch.core.queueing import (QUEUE, THINK, Branch,
                                               ClosedNetwork, Station,
                                               coalesced_network, disk_station)

        hit_ops, miss_ops = self.prefix.mean_ops_per_chunk()
        svc = PAPER_SERVICES.get(self.serve.policy, ServiceTimes())
        mpl = int(replicas) * int(self.serve.cores if cores is None else cores)
        delink = svc.delink / mpl if batched_update else svc.delink
        head = svc.head / mpl if batched_update else svc.head
        disk = disk_station(prefill_us, self.serve.disk_servers)
        stations = [
            Station("lookup", THINK, 0.51),
            disk,  # miss: chunk prefill recompute
            Station("step", THINK, step_us, dist="det"),
            Station("delink", QUEUE, delink),
            Station("head", QUEUE, head),
            Station("tail", QUEUE, svc.tail, bound="upper"),
            Station("scan", QUEUE, svc.scan),
        ]

        def visits(ops, miss):
            v = ["lookup", "step"] + (["disk"] if miss else [])
            d, h, t, s = (int(round(x)) for x in ops)
            return tuple(v + ["delink"] * d + ["head"] * h + ["tail"] * t
                         + ["scan"] * s)

        branches = [
            Branch("hit", lambda p: p, visits(hit_ops, False)),
            Branch("miss", lambda p: 1.0 - p, visits(miss_ops, True)),
        ]
        net = ClosedNetwork(f"serving-{self.serve.policy}", tuple(stations),
                            tuple(branches), mpl)
        n_shards = self.serve.n_shards if n_shards is None else int(n_shards)
        if tiers:
            from repro_torch.hierarchy import (TieredProfile, TierSpec,
                                               coalesced_hierarchy,
                                               compose_tiers)

            profile = tier_profile or TieredProfile.constant(
                0.5, n_shards=max(n_shards, 1))
            hm = compose_tiers(
                TierSpec(net=net, n_instances=int(tiers), name="l1"),
                TierSpec(net=net, n_instances=max(n_shards, 1), name="l2"),
                profile=profile, disk_us=prefill_us,
                disk_servers=self.serve.disk_servers,
                mpl=mpl * int(tiers))
            if coalesce_flows:
                return coalesced_hierarchy(hm, flows=coalesce_flows,
                                           window_us=prefill_us)
            return hm.network
        if n_shards > 1:
            from repro_torch.cluster import compose_cluster, uniform_profile

            profile = shard_profile or uniform_profile(n_shards)
            net = compose_cluster(net, profile, mpl=mpl * n_shards).network
        if coalesce_flows:
            net = coalesced_network(net, flows=coalesce_flows,
                                    window_us=prefill_us)
        return net
