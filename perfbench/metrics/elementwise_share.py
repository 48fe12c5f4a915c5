"""Per cent of the device time of the profiled slice spent outside the
port's own CUDA kernels (``rustray_tpu_torch/csrc/``): torch's elementwise,
reduction, sort, copy and memset work, which the shading ops are made of."""

# kernel names of the port's csrc/*.cu, as the profiler prints them
PORT_KERNELS = ("walk_units_kernel", "walk_fold_kernel", "round0_kernel",
                "round1_kernel", "set_if", "octet_bench")


def read(trace):
    total = sum(s for s, _ in trace.ops.values())
    if total <= 0:
        return None
    port = sum(s for name, (s, _) in trace.ops.items()
               if any(k in name for k in PORT_KERNELS))
    return 100.0 * (total - port) / total
