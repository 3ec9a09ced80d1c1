"""Shared set-up of the tests that hold the PyTorch port against the JAX
package in one process."""


def align_native():
    """Make both packages number the mesh edges alike in this process.

    Each package loads ``native/libgeomc.so`` through its own copy of
    ``fem/native.py`` and falls back to numpy (another, equally valid edge
    order) when the library cannot be built or loaded — e.g. while another
    test process is still writing it.  A parity test needs one order, so
    the port is handed whatever the JAX package ended up with."""
    import dolfin_navier_scipy_tpu.fem.native as jax_native
    import dolfin_navier_scipy_tpu_torch.fem.native as torch_native

    torch_native._LIB = jax_native._load()
    torch_native._TRIED = True
