"""Profile one warm graph pass on the GPU and name where its device time goes.

Builds the 16 x 1 Mbp bench input (bench.make_input, the 2^24 bucket),
runs construct.build_junctions once cold, then traces one warm pass
through utils/metrics.device_trace and reduces the trace to:

  * the top kernels by summed device time and launch count (compute
    stream lines of the GPU plane),
  * every kernel whose name contains "sort",
  * memcpy time per direction,
  * device busy time (union of kernel and copy intervals) over the pass's
    wall time.

Usage: python benchmarks/graph_trace.py [out_dir]   (default chiprun_out/
graph_trace); prints one JSON line and writes it to <out_dir>/summary.json.
"""

import collections
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def reduce_trace(path: str, top: int = 15) -> dict:
    """Device time by kernel from a GPU trace.  Kernels run inside CUDA
    graphs, so events carry kernel names, not HLO op names; numbered
    instances of one emitted kernel (XLA's sort stages: sort_12_1,
    sort_12_1__2, ...) are summed under the base name."""
    from jax._src.profiler import ProfileData

    kernels = collections.Counter()
    launches = collections.Counter()
    memcpy = collections.Counter()
    intervals = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                if "Memcpy" in line.name:
                    memcpy[e.name] += e.duration_ns
                else:
                    base = re.sub(r"__\d+$", "", e.name)
                    kernels[base] += e.duration_ns
                    launches[base] += 1
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {
        "top_kernels": [(n, ns, launches[n])
                        for n, ns in kernels.most_common(top)],
        "sort_kernels": [(n, ns, launches[n]) for n, ns in
                         kernels.most_common() if "sort" in n.lower()],
        "kernel_ns_total": sum(kernels.values()),
        "memcpy_ns": dict(memcpy),
        "device_busy_ns": busy,
    }


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "chiprun_out", "graph_trace")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"graph_trace: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    import bench
    from sibeliaz_tpu.graph import construct
    from sibeliaz_tpu.utils import metrics

    seqs, _ = bench.make_input()
    construct.build_junctions(seqs, bench.K)  # cold: compile
    os.environ["SIBELIAZ_TPU_PROFILE"] = out_dir
    t0 = time.time()
    with metrics.device_trace("graph_warm"):
        construct.build_junctions(seqs, bench.K)
    wall = time.time() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    summary = {"device_kind": dev.device_kind, "wall_s": wall,
               **reduce_trace(path)}
    summary["idle_share"] = 1 - summary["device_busy_ns"] / (wall * 1e9)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
