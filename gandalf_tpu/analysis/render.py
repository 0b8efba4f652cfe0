"""SPH kernel-interpolated rendering grids (analogue of Render,
src/Headers/Render.h:53-128 / src/Common/Render.cpp).

Shepard-normalised SPH interpolation of any particle quantity on a pixel
grid, exactly as the reference renders:

  values[c]     = sum_j wnorm_j A_j W(...)
  rendernorm[c] = sum_j wnorm_j     W(...)
  A(c)          = values[c] / rendernorm[c]   (where rendernorm > 1e-10)

with wnorm_j = (m_j/rho_j) / h_j^ndim (Render.cpp:212-252, 385-414).  For
3D column renders the kernel is the LOS-integrated 3D kernel wLOS
(Render.cpp:229 + TabulatedKernel::initializeTableLOS); 2D renders use the
2D kernel; slice renders (`zslice`) use the 3D kernel at the full 3D
distance including the pixel-to-plane offset (CreateSliceRenderingGrid,
Render.cpp:257-414).  Pixels sit at cell centres (rgrid, Render.cpp:344-352).

Device-side: one vectorised (pixels x particles) kernel sum chunked over
pixel rows — rendering is itself a jax op here, so it runs on the
accelerator (the reference renders in C++ on the host).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.smoothing import kernel_factory


def render_grid(snap, xquantity: str, yquantity: str, quantity: str,
                xmin: float, xmax: float, ymin: float, ymax: float,
                nx: int = 128, ny: int = 128, kernel: str = "m4",
                column: bool = True, zslice: float = None) -> np.ndarray:
    """2D rendering grid of `quantity` over the (xquantity, yquantity)
    plane (CreateColumnRenderingGrid / CreateSliceRenderingGrid,
    reference src/Common/Render.cpp:93-252, 257-414)."""
    axes = {"x": 0, "y": 1, "z": 2}
    ix = axes[xquantity]
    iy = axes[yquantity]
    r = np.asarray(snap.data["r"])
    ndim = r.shape[1]
    m = np.asarray(snap.data["m"])
    rho = np.asarray(snap.data["rho"])
    h = np.asarray(snap.data["h"])
    A = np.asarray(snap.extract_array(quantity))

    # pixel centres (reference rgrid, Render.cpp:344-352)
    dx = (xmax - xmin) / nx
    dy = (ymax - ymin) / ny
    px = xmin + (jnp.arange(nx) + 0.5) * dx
    py = ymin + (jnp.arange(ny) + 0.5) * dy

    rx = jnp.asarray(r[:, ix])
    ry = jnp.asarray(r[:, iy])
    hj = jnp.asarray(h)
    invh = 1.0 / hj
    wnorm = jnp.asarray(m / np.maximum(rho, 1e-300)) * invh ** ndim
    Aj = jnp.asarray(A)

    kern = kernel_factory(kernel, max(ndim, 2))

    if zslice is not None and ndim == 3:
        iz = ({0, 1, 2} - {ix, iy}).pop()
        dz = jnp.asarray(r[:, iz]) - zslice

        @jax.jit
        def row(yv):
            ddx = px[:, None] - rx[None, :]
            ddy = yv - ry[None, :]
            s = jnp.sqrt(ddx * ddx + ddy * ddy + dz[None, :] ** 2) \
                * invh[None, :]
            wk = wnorm[None, :] * kern.w0(s)
            return (jnp.sum(wk * Aj[None, :], axis=-1),
                    jnp.sum(wk, axis=-1))
    else:

        @jax.jit
        def row(yv):
            ddx = px[:, None] - rx[None, :]
            ddy = yv - ry[None, :]
            s = jnp.sqrt(ddx * ddx + ddy * ddy) * invh[None, :]
            # 3D columns integrate the kernel along the LOS (wLOS);
            # 2D uses the plane kernel; 1D renders nothing (wkern = 0,
            # Render.cpp:230-231)
            if ndim == 3:
                wk = kern.wLOS(s)
            elif ndim == 2:
                wk = kern.w0(s)
            else:
                wk = jnp.zeros_like(s)
            wk = wnorm[None, :] * wk
            return (jnp.sum(wk * Aj[None, :], axis=-1),
                    jnp.sum(wk, axis=-1))

    values, norm = jax.lax.map(row, py)
    values = jnp.where(norm > 1e-10, values / jnp.maximum(norm, 1e-30),
                       0.0)
    return np.asarray(values)
