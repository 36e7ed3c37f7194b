"""Residency accounting: hits/misses, bytes moved, modeled stall time.

All counters are plain python/numpy (host side) — they describe the engine's
externally-observable behaviour, mirroring the paper's Table 4 metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class LayerStats:
    hits: int = 0
    misses: int = 0
    host_computed: int = 0          # misses executed on host (n-cpu-moe analog)
    loads: int = 0                  # expert uploads to device slots
    bytes_loaded: int = 0
    reverse_rotations: int = 0
    forward_rotations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0


@dataclass
class EngineStats:
    layers: Dict[int, LayerStats] = field(default_factory=dict)
    steps: int = 0
    tokens: int = 0
    compute_s: float = 0.0          # modeled device compute time
    transfer_s: float = 0.0         # modeled host->device transfer time
    stall_s: float = 0.0            # transfer time NOT hidden behind compute
    host_compute_s: float = 0.0     # modeled host GEMM time for misses
    wall_s: float = 0.0             # measured wall time (reduced model, CPU)
    sync_pulls: int = 0             # queue-draining device->host reads (the
                                    # hot decode path does exactly 1 per token)
    overlapped_pulls: int = 0       # pipelined reads that overlap queued compute
    device_dispatches: int = 0      # host->device program launches the engine
                                    # issues (fused decode: 1 per miss-free token)
    lut_patch_dispatches: int = 0   # incremental LUT patch launches (subset of
                                    # device_dispatches; <=1 per layer per step)
    upload_dispatches: int = 0      # slot-upload scatter launches (fused: ONE
                                    # per rotation covering all weight tensors
                                    # and quant planes, not per expert/tensor)
    bytes_uploaded: int = 0         # real host->device slot-upload bytes (packed
                                    # bytes under int8/int4 — the link traffic the
                                    # quantized store shrinks ~2x / ~4x)
    replayed_steps: int = 0         # decode steps suffix-replayed after a miss
    replay_pulls: int = 0           # sync_pulls issued BY replay (subset of
                                    # sync_pulls; lets the speculative window's
                                    # 1-pull-per-window bound be checked net of
                                    # the exactness machinery's own reads)
    prefill_chunks: int = 0         # chunked-prefill launches (fused: ONE
                                    # compiled launch + one queue-draining pull
                                    # per chunk; walk: one chunk of the layer walk)
    prefill_replays: int = 0        # prefill chunks suffix-replayed after a miss
    spec_windows: int = 0           # speculative windows launched
    drafted_tokens: int = 0         # tokens self-drafted inside spec windows
    accepted_tokens: int = 0        # drafted tokens that committed (greedy
                                    # self-draft: rejections come only from
                                    # residency misses, so accept-rate < 1 is
                                    # a KV-rollback / replay canary)
    windows: int = 0                # serving decode launches over the paged
                                    # pool (every continuous-batching tick is
                                    # a window launch, size-1 included — the
                                    # 1-launch + 1-pull contract is checked
                                    # against this)
    kv_pages_allocated: int = 0     # KV pool pages drawn from the free list
    kv_pages_released: int = 0      # KV pool pages returned on request finish
    kv_pages_hwm: int = 0           # peak pages simultaneously in use (the
                                    # pool-pressure admission high-water mark)
    prefetch_launched: int = 0      # speculative expert uploads shipped into the
                                    # shadow generation during window compute
    prefetch_hits: int = 0          # prefetched uploads the authoritative
                                    # transition confirmed (flip reuses the
                                    # bytes; no boundary upload needed)
    prefetch_wasted_bytes: int = 0  # shadow bytes the transition disagreed with
                                    # (mispredicted slots, overwritten before
                                    # the flip by the correction pass)
    overlap_ms: float = 0.0         # wall time the prefetch work spent hidden
                                    # under in-flight window compute (dispatch
                                    # happens between the launch and its
                                    # queue-draining pull)
    relaunched_steps: int = 0       # compiled re-launches that replaced the
                                    # per-layer suffix replay (prefetch mode:
                                    # missed experts uploaded, planes patched
                                    # incrementally, step re-run miss-free)

    def layer(self, idx: int) -> LayerStats:
        return self.layers.setdefault(idx, LayerStats())

    @property
    def hits(self) -> int:
        return sum(l.hits for l in self.layers.values())

    @property
    def misses(self) -> int:
        return sum(l.misses for l in self.layers.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    @property
    def bytes_loaded(self) -> int:
        return sum(l.bytes_loaded for l in self.layers.values())

    @property
    def accept_rate(self) -> float:
        """Accepted / drafted over all speculative windows (1.0 when no
        speculation ran — the non-speculative path 'accepts' every token)."""
        return (
            self.accepted_tokens / self.drafted_tokens
            if self.drafted_tokens
            else 1.0
        )

    def modeled_step_time(self) -> float:
        """Per-token modeled latency: compute + unhidden transfer + host misses."""
        if self.steps == 0:
            return 0.0
        return (self.compute_s + self.stall_s + self.host_compute_s) / self.steps

    def per_layer(self) -> List[Dict[str, float]]:
        """Per-layer residency table (one row per MoE layer, index order).

        Surfaces the rotation-direction counters ``LayerStats`` has always
        tracked but ``summary()`` aggregates away — a layer rotating
        backwards (reverse_rotations) or re-loading heavily is the first
        thing to look at when ``hit_rate`` regresses.
        """
        rows: List[Dict[str, float]] = []
        for idx in sorted(self.layers):
            l = self.layers[idx]
            rows.append({
                "layer": idx,
                "hit_rate": round(l.hit_rate, 4),
                "hits": l.hits,
                "misses": l.misses,
                "host_computed": l.host_computed,
                "loads": l.loads,
                "bytes_loaded_MB": round(l.bytes_loaded / 2**20, 3),
                "forward_rotations": l.forward_rotations,
                "reverse_rotations": l.reverse_rotations,
            })
        return rows

    def per_layer_table(self) -> str:
        """``per_layer()`` pretty-printed for the examples / CLI."""
        header = (f"{'layer':>5} {'hit_rate':>8} {'misses':>7} {'loads':>6} "
                  f"{'MB':>8} {'fwd_rot':>7} {'rev_rot':>7}")
        lines = [header]
        for r in self.per_layer():
            lines.append(
                f"{r['layer']:>5} {r['hit_rate']:>8.4f} {r['misses']:>7} "
                f"{r['loads']:>6} {r['bytes_loaded_MB']:>8.3f} "
                f"{r['forward_rotations']:>7} {r['reverse_rotations']:>7}"
            )
        return "\n".join(lines)

    def summary(self) -> Dict[str, float]:
        return {
            "steps": self.steps,
            "tokens": self.tokens,
            "hit_rate": round(self.hit_rate, 4),
            "misses": self.misses,
            "bytes_loaded_MB": round(self.bytes_loaded / 2**20, 2),
            "bytes_uploaded_MB": round(self.bytes_uploaded / 2**20, 2),
            "modeled_ms_per_token": round(1e3 * self.modeled_step_time(), 3),
            "modeled_tok_per_s": round(
                1.0 / self.modeled_step_time() if self.modeled_step_time() else 0.0, 2
            ),
            "measured_wall_s": round(self.wall_s, 3),
            "stall_s": round(self.stall_s, 4),
            "sync_pulls": self.sync_pulls,
            "overlapped_pulls": self.overlapped_pulls,
            "device_dispatches": self.device_dispatches,
            "lut_patch_dispatches": self.lut_patch_dispatches,
            "upload_dispatches": self.upload_dispatches,
            "replayed_steps": self.replayed_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_replays": self.prefill_replays,
            "spec_windows": self.spec_windows,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": round(self.accept_rate, 4),
            "windows": self.windows,
            "kv_pages_allocated": self.kv_pages_allocated,
            "kv_pages_released": self.kv_pages_released,
            "kv_pages_hwm": self.kv_pages_hwm,
            "prefetch_launched": self.prefetch_launched,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_wasted_bytes": self.prefetch_wasted_bytes,
            "overlap_ms": round(self.overlap_ms, 3),
            "relaunched_steps": self.relaunched_steps,
        }
