"""The device a benchmark measures."""

from __future__ import annotations


def measured_device(cpu_rehearsal: bool = False) -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices.

    Benchmarks measure the GPU: any other backend is refused unless
    ``cpu_rehearsal`` is set, for a dry run whose output then names the
    CPU as its device."""
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] != "gpu" and not cpu_rehearsal:
        raise SystemExit(
            f"no GPU: JAX runs on {info['platform']}; pass --cpu-rehearsal "
            "for a dry run on the CPU"
        )
    return info
