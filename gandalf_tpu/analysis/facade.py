"""User-facing facade (analogue of reference analysis/facade.py:185-1140).

Provides the same core surface the reference regression tests rely on:
``newsim / setupsim / run / run_async / snap / next / previous / get_data``
plus the SimBuffer snapshot cache.  Plotting commands are stubs until the
rendering milestone.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..params import Parameters
from ..sim.simulation import SimulationBase, Snapshot


class _SimBuffer:
    """Singleton snapshot/sim cache (reference analysis/SimBuffer.py:30)."""

    def __init__(self) -> None:
        self.sims: List[SimulationBase] = []
        self.current_sim: Optional[SimulationBase] = None
        self.current_snap_index: int = -1

    def add_sim(self, sim: SimulationBase) -> None:
        self.sims.append(sim)
        self.current_sim = sim
        self.current_snap_index = -1

    def get_sim(self, which="current") -> SimulationBase:
        if which == "current" or which is None:
            if self.current_sim is None:
                raise RuntimeError("No simulation in buffer")
            return self.current_sim
        return self.sims[int(which)]

    def get_snapshot_and_sim(self, snap="current", sim="current"):
        s = self.get_sim(sim)
        if not s.snapshots:
            raise RuntimeError("Simulation has no snapshots")
        if snap == "current" or snap is None:
            idx = self.current_snap_index
        elif snap == "live":
            idx = len(s.snapshots) - 1
        else:
            idx = int(snap)
        return s.snapshots[idx], s

    def reset(self) -> None:
        self.sims = []
        self.current_sim = None
        self.current_snap_index = -1


SimBuffer = _SimBuffer()


# -- facade functions ---------------------------------------------------------

def newsim(paramfile: Optional[str] = None, ndim: Optional[int] = None,
           sim: Optional[str] = None) -> SimulationBase:
    """Create a simulation from a parameter file and/or explicit options
    (reference facade.py:659)."""
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    params = Parameters()
    if paramfile is not None:
        params.read_file(paramfile)
    if ndim is not None:
        params.set("ndim", ndim)
    if sim is not None:
        params.set("sim", sim)
    simulation = SimulationBase.factory(params)
    SimBuffer.add_sim(simulation)
    return simulation


def setupsim() -> SimulationBase:
    """Set up the current simulation (reference facade.py:669)."""
    s = SimBuffer.get_sim()
    s.SetupSimulation()
    return s


def run(time: Optional[float] = None) -> None:
    """Run the current simulation to `tend` (reference facade.py:679)."""
    s = SimBuffer.get_sim()
    if time is not None:
        if not s.setup_complete:
            s.SetParam("tend", time)
        else:
            s.params.floatparams["tend"] = float(time)
    s.Run()
    SimBuffer.current_snap_index = len(s.snapshots) - 1


class _AsyncRun:
    """Process-handle analogue of the reference facade.run_async
    (facade.py:714-758, which MPI-spawns a gandalf binary): the run
    executes on a background thread (single-controller JAX stays
    in-process); wait() joins and re-raises any failure."""

    def __init__(self, sim: SimulationBase):
        import threading

        self.sim = sim
        self._exc = None

        def target():
            try:
                sim.Run()
            except BaseException as e:      # noqa: BLE001
                self._exc = e

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def poll(self):
        return None if self._thread.is_alive() else 0

    def wait(self) -> None:
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        SimBuffer.current_snap_index = len(self.sim.snapshots) - 1


def run_async(time: Optional[float] = None) -> _AsyncRun:
    s = SimBuffer.get_sim()
    if time is not None and not s.setup_complete:
        s.SetParam("tend", time)
    if not s.setup_complete:
        s.SetupSimulation()
    return _AsyncRun(s)


def loadsim(run_id: str, fileformat: str = None) -> SimulationBase:
    """Load snapshots from disk into a read-only sim (facade.py:185);
    column and SEREN-unformatted (su) formats auto-detected."""
    import glob

    from ..sim import io as sim_io

    params = Parameters()
    params.stringparams["run_id"] = run_id
    # reload the recorded parameter file when available
    import os

    if os.path.exists(f"{run_id}.param"):
        with open(f"{run_id}.param") as f:
            for line in f:
                params.parse_line(line)
    sim = SimulationBase.__new__(SimulationBase)
    SimulationBase.__init__(sim, params)
    forms = [fileformat] if fileformat else ["column", "su", "sf"]
    for form in forms:
        files = sorted(glob.glob(f"{run_id}.{form}.*"))
        for fn in files:
            if fn.endswith(".tmp"):
                continue
            if form == "su":
                t, data = sim_io.read_seren_unform(fn)
            elif form == "sf":
                t, data = sim_io.read_seren_form(fn)
            else:
                t, data = sim_io.read_column_snapshot(fn)
            ndim = data["r"].shape[1]
            sim.snapshots.append(Snapshot(t, data, ndim))
        if files:
            break
    sim.ndim = sim.snapshots[0].ndim if sim.snapshots else 1
    SimBuffer.add_sim(sim)
    SimBuffer.current_snap_index = len(sim.snapshots) - 1
    return sim


def snap(no: int):
    """Jump to snapshot `no` (negative = from end; reference facade.py)."""
    s = SimBuffer.get_sim()
    n = len(s.snapshots)
    idx = no if no >= 0 else n + no
    if not 0 <= idx < n:
        raise IndexError(f"snapshot {no} out of range ({n} snapshots)")
    SimBuffer.current_snap_index = idx
    return s.snapshots[idx]


def next():  # noqa: A001  (reference facade uses this name)
    return snap(SimBuffer.current_snap_index + 1)


def previous():
    return snap(SimBuffer.current_snap_index - 1)


def get_data(quantity: str, snap_no="current", sim="current",
             type: str = "default") -> np.ndarray:
    """Fetch a quantity: direct arrays, derived quantities, or registered
    user formulas (reference facade.get_data -> data_fetcher).  With
    ``type="star"`` the quantity is read from the snapshot's star/sink
    block instead of the gas particles (the reference's per-type fetch,
    data_fetcher.py particle types)."""
    from .fetchers import fetch_quantity

    snapshot, _ = SimBuffer.get_snapshot_and_sim(snap_no, sim)
    if type == "star":
        from ..sim.simulation import Snapshot as _Snap

        star = snapshot.data.get("star")
        if star is None:
            return np.array([])
        return _Snap(snapshot.t, dict(star), snapshot.ndim) \
            .extract_array(quantity)
    return fetch_quantity(snapshot, quantity)


def CreateUserQuantity(name: str, formula: str, unitlabel: str = "",
                       unitname: str = "", scaling_factor: float = 1.0,
                       label: str = ""):
    """Register a formula quantity usable in get_data/plot
    (reference facade.CreateUserQuantity -> data_fetcher.py:55)."""
    from .fetchers import CreateUserQuantity as _create

    return _create(name, formula, unitlabel, unitname, scaling_factor,
                   label)


def get_time(snap_no="current", sim="current") -> float:
    snapshot, _ = SimBuffer.get_snapshot_and_sim(snap_no, sim)
    return snapshot.t


def get_render_data(xquantity: str, yquantity: str, quantity: str = "rho",
                    snap_no="current", sim="current",
                    xmin=None, xmax=None, ymin=None, ymax=None,
                    res: int = 128, zslice: float = None) -> np.ndarray:
    """Kernel-interpolated rendering grid (facade.get_render_data);
    with `zslice` a true z-plane slice (CreateSliceRenderingGrid)."""
    from .render import render_grid

    snapshot, _ = SimBuffer.get_snapshot_and_sim(snap_no, sim)
    axes = {"x": 0, "y": 1, "z": 2}
    r = snapshot.data["r"]
    ix, iy = axes[xquantity], axes[yquantity]
    xmin = r[:, ix].min() if xmin is None else xmin
    xmax = r[:, ix].max() if xmax is None else xmax
    ymin = r[:, iy].min() if ymin is None else ymin
    ymax = r[:, iy].max() if ymax is None else ymax
    return render_grid(snapshot, xquantity, yquantity, quantity,
                       xmin, xmax, ymin, ymax, nx=res, ny=res,
                       zslice=zslice)


def render(x: str = "x", y: str = "y", render_quantity: str = "rho",
           res: int = 128, snap="current", sim="current",
           zslice: float = None, **kw):
    """Render a quantity to a matplotlib image (facade.render); with
    `zslice` a true z-plane slice rather than a column integral
    (reference facade.render passes zslice through to
    RenderPlotCommand, analysis/facade.py:419-436)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = get_render_data(x, y, render_quantity, snap, sim, res=res,
                           zslice=zslice)
    fig, axis = plt.subplots()
    im = axis.imshow(grid, origin="lower", aspect="auto")
    fig.colorbar(im, ax=axis, label=render_quantity)
    axis.set_xlabel(x)
    axis.set_ylabel(y)
    return fig


def renderslice(x: str, y: str, render_quantity: str, zslice: float,
                **kw):
    """Slice rendering at plane z = zslice (reference facade.renderslice,
    analysis/facade.py:419: a thin wrapper around render with zslice)."""
    return render(x, y, render_quantity, zslice=zslice, **kw)


def addrender(x: str, y: str, render_quantity: str, **kw):
    """Overplot variant of render (reference facade.addrender)."""
    return render(x, y, render_quantity, **kw)


def addrenderslice(x: str, y: str, render_quantity: str, zslice: float,
                   **kw):
    """Overplot variant of renderslice (reference facade.addrenderslice)."""
    return renderslice(x, y, render_quantity, zslice, **kw)


def time_plot(x: str, y: str, sim="current", id=None, idx=None, idy=None,
              **kw):
    """Plot two quantities as evolved in time, one versus the other
    (reference facade.time_plot, analysis/facade.py:276): each axis is
    either a time-defined quantity ('t' or a registered global time
    series) or a per-particle quantity tracked for particle `id`
    (`idx`/`idy` override per axis)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = SimBuffer.get_sim(sim)

    def series(q, pid):
        if q == "t":
            return np.array([snap.t for snap in s.snapshots])
        if q in _TIME_FETCHERS:
            return TimeData(q, sim=sim)[1]
        if pid is None:
            pid = 0 if id is None else id
        _, vals = CreateTimeData(q, id=pid, sim=sim)
        return vals

    xs = _apply_scale(x, series(x, idx))
    ys = _apply_scale(y, series(y, idy))
    fig, axis = plt.subplots()
    axis.plot(xs, ys, "-")
    axis.set_xlabel(x)
    axis.set_ylabel(y)
    if x in _PLOT_LIMITS:
        axis.set_xlim(*_PLOT_LIMITS[x])
    if y in _PLOT_LIMITS:
        axis.set_ylim(*_PLOT_LIMITS[y])
    return fig


# -- plot windows / limits / unit rescaling (reference facade.py:525-940) ----

_PLOT_LIMITS: dict = {}
_PLOT_SCALES: dict = {}


def window(no=None):
    """Switch to (or create) a numbered plot window
    (reference facade.window :626)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(no)
    return fig


def subfigure(nx: int, ny: int, current: int):
    """Select subplot `current` of an nx x ny grid in the active window
    (reference facade.subfigure :641)."""
    import matplotlib.pyplot as plt

    return plt.gcf().add_subplot(nx, ny, current)


def limit(quantity: str, min=None, max=None, auto: bool = False,
          window="current", subfigure="current"):
    """Set (or with auto=True clear) the plotted range of a quantity;
    applies to the current axes and is remembered for later plots
    (reference facade.limit :525)."""
    import matplotlib.pyplot as plt

    if auto:
        _PLOT_LIMITS.pop(quantity, None)
    else:
        _PLOT_LIMITS[quantity] = (min, max)
    ax = plt.gca() if plt.get_fignums() else None
    if ax is not None and not auto:
        if ax.get_xlabel() == quantity:
            ax.set_xlim(min, max)
        if ax.get_ylabel() == quantity:
            ax.set_ylim(min, max)


def rescale(quantity: str, unitname: str, window="current"):
    """Change the display unit of a quantity for subsequent plots
    (reference facade.rescale :865); uses the current sim's unit system."""
    s = SimBuffer.get_sim()
    units = getattr(s, "units", None)
    if units is None:
        raise ValueError("current simulation has no unit system "
                         "(dimensionless run)")
    unit = getattr(units, _UNIT_OF.get(quantity, quantity), None)
    if unit is None:
        raise ValueError(f"no unit dimension known for {quantity!r}")
    _PLOT_SCALES[quantity] = unit.output_scale(unitname)


_UNIT_OF = {
    "x": "r", "y": "r", "z": "r", "vx": "v", "vy": "v", "vz": "v",
    "m": "m", "h": "r", "rho": "rho", "u": "u", "t": "t",
    "pressure": "press",
}


def _apply_scale(name, arr):
    s = _PLOT_SCALES.get(name)
    return arr if s is None else arr * s


def plot(x: str, y: str, snap="current", sim="current",
         type: str = "default", **kw):
    """Scatter plot of two particle quantities (facade.plot);
    ``type="star"`` plots the star/sink particles.

    Uses the Agg backend (figures saved via savefig); the reference's
    interactive subprocess plotting window is not replicated."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = _apply_scale(x, get_data(x, snap, sim, type=type))
    ys = _apply_scale(y, get_data(y, snap, sim, type=type))
    fig, axis = plt.subplots()
    axis.plot(xs, ys, ".", ms=2)
    axis.set_xlabel(x)
    axis.set_ylabel(y)
    if x in _PLOT_LIMITS:
        axis.set_xlim(*_PLOT_LIMITS[x])
    if y in _PLOT_LIMITS:
        axis.set_ylim(*_PLOT_LIMITS[y])
    return fig


def savefig(filename: str, fig=None):
    import matplotlib.pyplot as plt

    (fig or plt.gcf()).savefig(filename, dpi=120)


def addplot(x, y, **kw):
    return plot(x, y, **kw)


def plotanalytical(x: str, y: str, ic: str = None, snap="current",
                   sim="current", **kw):
    """Overlay the analytic solution (facade.plotanalytical)."""
    from .analytical import compute_analytical

    snapshot, simulation = SimBuffer.get_snapshot_and_sim(snap, sim)
    ic = ic or simulation.params.stringparams["ic"]
    ax_, ay_ = compute_analytical(ic, simulation, snapshot.t, x, y)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.plot(ax_, ay_, "-")
    return ax_, ay_


def make_movie(filename: str = "movie.mp4", x: str = "x", y: str = "y",
               render_quantity: str = "rho", res: int = 128,
               sim="current", fps: int = 10):
    """Write a movie of rendered snapshots (facade.make_movie); falls back
    to a directory of PNG frames when no movie writer is available."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    s = SimBuffer.get_sim(sim)
    frames = [get_render_data(x, y, render_quantity, i, sim, res=res)
              for i in range(len(s.snapshots))]
    fig, axis = plt.subplots()
    im = axis.imshow(frames[0], origin="lower", aspect="auto")

    def update(i):
        im.set_data(frames[i])
        return [im]

    ani = animation.FuncAnimation(fig, update, frames=len(frames))
    try:
        ani.save(filename, fps=fps)
    except Exception:
        import os

        base = filename.rsplit(".", 1)[0]
        os.makedirs(base, exist_ok=True)
        for i, fr in enumerate(frames):
            im.set_data(fr)
            fig.savefig(f"{base}/frame{i:04d}.png")
        return base
    return filename


#: name -> (function, args, kwargs): global time-series quantities
#: registered via CreateTimeData(name, function, ...) (the reference's
#: data_fetcher.time_fetchers / FunctionTimeDataFetcher registry,
#: analysis/data_fetcher.py:94-130)
_TIME_FETCHERS: dict = {}


def CreateTimeData(quantity: str, function=None, *args,
                   id: int = 0, sim="current", **kwargs):
    """Two forms, matching the reference:

    - ``CreateTimeData(name, function, **kwargs)`` registers a GLOBAL
      time quantity: `function(snap, **kwargs)` is evaluated per
      snapshot and the series is plottable with `time_plot("t", name)`
      (reference data_fetcher.CreateTimeData, analysis/
      data_fetcher.py:94 — e.g. lagrangian_radii with mfrac=0.5).
    - ``CreateTimeData(quantity, id=i)`` returns the (t, value) series
      of a per-particle quantity for particle `i` across snapshots
      (the reference's TimeData / particle_data fetcher path)."""
    if callable(function):
        _TIME_FETCHERS[quantity] = (function, args, kwargs)
        return _TIME_FETCHERS[quantity]
    simulation = SimBuffer.get_sim(sim)
    ts = np.array([s.t for s in simulation.snapshots])
    qs = np.array([s.extract_array(quantity)[id]
                   for s in simulation.snapshots])
    return ts, qs


def TimeData(quantity: str, id: int = None, sim="current"):
    """Evaluate a time-series quantity over all snapshots: a registered
    global quantity (CreateTimeData with a function) or, with `id`, a
    per-particle quantity (reference data_fetcher.TimeData,
    analysis/data_fetcher.py:114-130).  Returns (t, values)."""
    simulation = SimBuffer.get_sim(sim)
    ts = np.array([s.t for s in simulation.snapshots])
    if quantity in _TIME_FETCHERS:
        fn, args, kwargs = _TIME_FETCHERS[quantity]
        vals = np.array([fn(s, *args, **kwargs)
                         for s in simulation.snapshots])
        return ts, vals
    if id is None:
        raise KeyError(
            f"TimeData: '{quantity}' is not a registered time quantity "
            "and no particle id was given")
    return CreateTimeData(quantity, id=id, sim=sim)


def L1errornorm(ic, x=None, y=None, xmin=None, xmax=None, **kw):
    """Convenience re-export (reference exposes it on the facade too)."""
    from .compute import L1errornorm as _l1

    return _l1(ic, x, y, xmin, xmax, **kw)
