"""Device-time benchmark of the codec's device route on one GPU.

For each configuration it prints one JSON line with the card's name and
power limit beside:

* compile time and compiled memory of every device step;
* device time per frame of the encode: the measured-schedule prepass
  (``ops.coding.measured_spec``) and the merge tree
  (``encode_batch_device``);
* device time per frame of two decode forms: the split tree that
  ``ops.decode`` runs (``decode_batch_device``) and the direct gather form
  (``decode_batch_direct``);
* the serial host header walk of a foreign archive (no index);
* each device step's share of the card's HBM bandwidth, counting only the
  bytes the step must move (pixels in or out, compressed bytes out or in);
  the trees move several times more internally, so this is a floor.

Device times are host-clock times around a call on device-resident inputs
that ends in ``block_until_ready``, best of ``--reps``; host<->device
transfer is not in them. Every archive is compared with the native host
codec's bytes and every decode with the frames.

Run on a GPU: ``python bench.py [--cells 512,2048,4096] [--reps N]``. It
refuses to run on the CPU and on a device kind missing from
``runtime.metrics.HBM_GBS``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: name -> (edge, dtype, frames per batch, hot-pixel value); 512² u16 is
#: BASELINE.json configs 1-2, 2048² / 4096² u32 overflow-heavy config 3
CELLS = {
    "512": (512, np.uint16, 256, 60000),
    "2048": (2048, np.uint32, 8, 2_000_000_000),
    "4096": (4096, np.uint32, 4, 2_000_000_000),
}


def diffraction_frames(seed: int, F: int, edge: int, dtype,
                       hot: int) -> np.ndarray:
    """(F, edge, edge) synthetic diffraction frames: Poisson(3) background
    plus ~200 hot pixels per frame at ``hot`` (compresses to ~0.2 of raw
    at 512² u16)."""
    rng = np.random.default_rng(seed)
    frames = rng.poisson(3.0, size=(F, edge * edge)).astype(dtype)
    frames[np.repeat(np.arange(F), 200),
           rng.integers(0, edge * edge, 200 * F)] = hot
    return frames.reshape(F, edge, edge)


def card() -> str:
    """``name, power limit`` of the first GPU as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _best(fn, args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _compile(jitted, *args):
    """(compiled executable, compile seconds, memory summary)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    summary = {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if mem is not None and hasattr(mem, k)}
    return compiled, dt, summary


def bench_cell(name: str, reps: int, peak_gbs: float) -> dict:
    import jax

    from trpx_tpu.native import codec as ncodec
    from trpx_tpu.ops.coding import (
        FrameSpec,
        _pad_batch,
        assemble_archive,
        decode_batch_device,
        decode_batch_direct,
        encode_batch_device,
        narrow_values,
        walk_archive,
    )
    from trpx_tpu.ops.pack import (
        encode_level_maxima,
        measured_schedule,
        row_capacity,
    )

    edge, dtype, F, hot = CELLS[name]
    frames = diffraction_frames(7, F, edge, dtype, hot).reshape(F, -1)
    n = edge * edge
    raw = frames.nbytes
    spec = FrameSpec.for_dtype(n, dtype)
    x = jax.device_put(_pad_batch(frames, spec, bucket=False))
    r: dict = {"cell": f"{edge}x{edge} {np.dtype(dtype).name}", "frames": F}

    # encode: measured-schedule prepass, then the merge tree
    pre, r["compile_s_prepass"], _ = _compile(
        jax.jit(encode_level_maxima, static_argnums=0), spec, x)
    t_pre = _best(pre, (x,), reps)
    mx = np.asarray(pre(x))
    spec_m = spec.with_sched(measured_schedule(
        spec.tree_rows, row_capacity(spec.max_block_bits),
        spec.max_block_bits, mx))
    enc, r["compile_s_encode"], r["mem_encode"] = _compile(
        encode_batch_device, spec_m, x)
    t_enc = _best(enc, (x,), reps)
    words, bits, maxw, over = jax.device_get(enc(x))
    assert not np.any(over), "measured schedule overflowed"
    arch = assemble_archive(spec_m, words, bits, maxw)
    ref = ncodec.encode(frames)
    assert arch.to_bytes() == ref.to_bytes(), f"{name}: archive != native"
    comp = arch.meta.memory_size

    # host header walk of the foreign (index-free) archive
    walk_archive(ref, spec)  # cold: native library load + payload copy
    t_walk = []
    for _ in range(3):
        cold = type(ref)(meta=ref.meta, payload=ref.payload)
        t0 = time.perf_counter()
        widths, _p, wbuf = walk_archive(cold, spec)
        t_walk.append(time.perf_counter() - t0)
    w_d, wd_d = jax.device_put(wbuf), jax.device_put(widths)

    dec = {}
    for form, fn in (("tree", decode_batch_device),
                     ("direct", decode_batch_direct)):
        c, r[f"compile_s_decode_{form}"], r[f"mem_decode_{form}"] = _compile(
            fn, spec, w_d, wd_d)
        dec[form] = _best(c, (w_d, wd_d), reps)
        vals = np.asarray(jax.device_get(c(w_d, wd_d)))[:, :n]
        assert np.array_equal(narrow_values(vals, np.dtype(dtype)), frames), \
            f"{name}: {form} decode != frames"

    ms = 1e3 / F
    r.update({
        "compression": round(comp / raw, 4),
        "encode_prepass_ms_per_frame": t_pre * ms,
        "encode_tree_ms_per_frame": t_enc * ms,
        "decode_tree_ms_per_frame": dec["tree"] * ms,
        "decode_direct_ms_per_frame": dec["direct"] * ms,
        "host_walk_ms_per_frame": float(np.median(t_walk)) * ms,
        "encode_hbm_share": (raw + comp) / (t_pre + t_enc) / (peak_gbs * 1e9),
        "decode_tree_hbm_share": (raw + comp) / dec["tree"] / (peak_gbs * 1e9),
        "decode_direct_hbm_share":
            (raw + comp) / dec["direct"] / (peak_gbs * 1e9),
        "peak_bytes_in_use":
            (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use"),
    })
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=",".join(CELLS),
                   help=f"comma-separated subset of {', '.join(CELLS)}")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import jax

    from trpx_tpu.runtime.compile_cache import enable_compile_cache
    from trpx_tpu.runtime.metrics import HBM_GBS

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, jax found {dev.platform}",
              file=sys.stderr)
        return 2
    if dev.device_kind not in HBM_GBS:
        print(f"bench.py: no HBM peak for device kind {dev.device_kind!r}"
              " in runtime.metrics.HBM_GBS", file=sys.stderr)
        return 2
    head = {"card": card(), "device_kind": dev.device_kind,
            "count": len(jax.devices()), "peak_gbs": HBM_GBS[dev.device_kind]}
    print(json.dumps(head), flush=True)
    for name in args.cells.split(","):
        r = bench_cell(name, args.reps, HBM_GBS[dev.device_kind])
        print(json.dumps({**r, "card": head["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
