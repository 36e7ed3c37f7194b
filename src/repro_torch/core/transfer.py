"""Host<->device transfer cost model and the modeled clock.

The port's counterpart of ``repro.core.transfer``. The reference carried a
TPU's constants; this copy keeps none of them. Its host-link figure is
MEASURED when an engine starts on the card (:meth:`CostModel.measure` times
pinned-host -> device copies), and its device peaks are the H100 SXM data
sheet's (989 TFLOP/s dense bf16, 3.35 TB/s HBM). An engine on the CPU has no
link to measure and gets :meth:`CostModel.unmeasured`, whose link figure is
NaN: its modeled transfer and stall times then read NaN instead of a number
that no card produced.

``TransferClock`` is the reference's modeled overlap of slot uploads with
device compute, unchanged.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class CostModel:
    host_link_gbs: float                 # pinned host -> device copy rate (measured)
    link_latency_us: float               # one small pinned copy, end to end (measured)
    device_flops: float = 989e12         # H100 SXM dense bf16 peak (data sheet)
    device_hbm_gbs: float = 3350.0       # H100 SXM HBM3 (data sheet)
    host_flops: float = 100e9            # host GEMM rate the miss correction is modeled at
    mma_efficiency: float = 0.6          # modeled fraction of peak on GEMV-ish decode

    @classmethod
    def unmeasured(cls) -> "CostModel":
        """No card to measure: every modeled transfer reads NaN."""
        return cls(host_link_gbs=math.nan, link_latency_us=math.nan)

    @classmethod
    def measure(cls, device, nbytes: int = 64 << 20, reps: int = 5) -> "CostModel":
        """Time pinned-host -> ``device`` copies on the card: ``nbytes`` for
        the rate (best of ``reps``), 4 KiB for the latency. Takes well under
        a second at the default size."""
        import torch

        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the link is measured on a CUDA device, got {dev}")
        src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        small_src = src[:4096]
        small_dst = dst[:4096]
        dst.copy_(src, non_blocking=True)                # warm-up
        torch.cuda.synchronize(dev)
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        lat = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            small_dst.copy_(small_src, non_blocking=True)
            torch.cuda.synchronize(dev)
            lat = min(lat, time.perf_counter() - t0)
        return cls(host_link_gbs=nbytes / best / 1e9, link_latency_us=lat * 1e6)

    def transfer_s(self, nbytes: int) -> float:
        return self.link_latency_us * 1e-6 + nbytes / (self.host_link_gbs * 1e9)

    def compute_s(self, flops: float, bytes_touched: float = 0.0) -> float:
        """Roofline max of compute and HBM time for a device-side op."""
        t_c = flops / (self.device_flops * self.mma_efficiency)
        t_m = bytes_touched / (self.device_hbm_gbs * 1e9)
        return max(t_c, t_m)

    def host_compute_s(self, flops: float) -> float:
        return flops / self.host_flops


class TransferClock:
    """Tracks modeled overlap between prefetch DMA and device compute.

    Usage per decode step: ``begin_step()``, then for every layer
    ``prefetch(nbytes)`` (async, issued before the layer) and
    ``compute(seconds)``; blocking loads call ``blocking(nbytes)``.
    ``stall_s`` accumulates DMA time that compute could not hide.
    """

    def __init__(self, cost: CostModel):
        self.cost = cost
        self.device_t = 0.0          # device busy-until
        self.dma_t = 0.0             # dma busy-until
        self.compute_s = 0.0
        self.transfer_s = 0.0
        self.stall_s = 0.0
        self.host_s = 0.0

    @property
    def hidden_s(self) -> float:
        """Modeled DMA seconds hidden behind device compute."""
        return max(0.0, self.transfer_s - self.stall_s)

    def prefetch(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        t = self.cost.transfer_s(nbytes)
        self.transfer_s += t
        self.dma_t = max(self.dma_t, self.device_t) + t

    def compute(self, seconds: float, *, needs_dma: bool = True) -> None:
        """Run a layer; if its weights are still in flight, the device waits."""
        start = self.device_t
        if needs_dma and self.dma_t > start:
            self.stall_s += self.dma_t - start
            start = self.dma_t
        self.device_t = start + seconds
        self.compute_s += seconds

    def blocking(self, nbytes: int) -> None:
        """Critical-path load: device idles for the whole transfer."""
        t = self.cost.transfer_s(nbytes)
        self.transfer_s += t
        self.stall_s += t
        self.device_t = max(self.device_t, self.dma_t) + t
        self.dma_t = self.device_t

    def host(self, seconds: float) -> None:
        """Host-executed miss overlaps nothing (result needed before next layer)."""
        self.host_s += seconds
        self.device_t += seconds
