"""The traversal kernels' share of their roofline, in per cent.

Least time: the bytes that the traversal of the profiled frames must move
at the card's peak bandwidth, each read once and written once: per device
ray 32 B in (origin, direction, t_max) and 8 B out (t, triangle index),
and the scene's triangles (3 vertices of 12 B) once per trace pass that the
configuration's ray tree defines (a closest and a shadow pass per level,
chunk and sample).  The count comes from the configuration and from
``device_rays``, never from the kernels' launches or visit lists, so it is
the same whatever walk implements the traversal.  Divided by the device
time of the traversal kernels by name (the block walk's two passes, the
octet rounds).  Bytes bound it: the ray-triangle tests are data-dependent
and not counted.

Peak: 3.35 TB/s, the HBM3 bandwidth of one H100 SXM (NVIDIA's data
sheet), at its 700 W power limit; a card set lower runs below it.
"""

PEAK_BYTES_S = 3.35e12
RAY_BYTES = 32 + 8
TRI_BYTES = 3 * 12
KERNELS = ("walk_units_kernel", "walk_fold_kernel", "round0_kernel",
           "round1_kernel")


def least_bytes(device_rays, n_tris, n_chunks, samples, n_levels):
    """Bytes the traversal of a frame must move."""
    passes = 2 * n_levels * n_chunks * samples
    return device_rays * RAY_BYTES + passes * n_tris * TRI_BYTES


def read(trace):
    t = sum(s for name, (s, _) in trace.ops.items()
            if any(k in name for k in KERNELS))
    info = trace.info
    if t <= 0 or not trace.steps or "n_tris" not in info:
        return None
    b = sum(least_bytes(s["device_rays"], info["n_tris"], info["n_chunks"],
                        info["samples"], info["n_levels"])
            for s in trace.steps)
    return 100.0 * (b / PEAK_BYTES_S) / t
