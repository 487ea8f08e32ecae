"""Profile the port's flagship decode on a GPU.

    python -m soundkit_tpu_torch.tools.profile_step

Decodes ``STEPS`` lockstep batches of the committed fixtures' smoke
lanes (lane i: clip i mod 6 from AU i // 6) through
``models.aac_lc_batch.BatchedAacLcDecoder`` under ``torch.profiler``,
one warm-up batch first, and prints per batch: the wall time (host
parse, copy and step, synchronized per batch, as ``chip_smoke.py``
times it), the decoder's own stage medians, the device time summed
over the kernels, the device busy share, the launch count and the
kernels that take the most device time.
"""
from __future__ import annotations

import json
import time

B = 1024
STEPS = 5


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu_torch.tools.aac_fixtures import lane_streams, load_clips

    model = BatchedAacLcDecoder(B, 2, device="cuda", timed=True)
    for i, data in enumerate(lane_streams(load_clips(), B, STEPS + 1)):
        model.push(i, data)
    model.decode_batches(1, device_out=True)  # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            model.decode_batches(1, device_out=True)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    if model.full_wire_batches:
        raise RuntimeError(f"{model.full_wire_batches} batches left the v4 wire")

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / STEPS
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "batch": B, "steps": STEPS, "batch_wall_ms": wall_ms,
        "stage_ms": model.stage_ms(), "batch_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ops_per_batch": len(kernels) / STEPS,
    }))
    for name, ms in top:
        print(f"{ms:9.4f} ms/batch  {name[:110]}")


if __name__ == "__main__":
    main()
