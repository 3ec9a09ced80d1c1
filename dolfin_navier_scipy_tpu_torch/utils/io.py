"""Data output, caching and timing utilities.

Twin of the JAX package's ``utils/io.py`` (itself the reference's
``data_output_utils.py``): array persistence (:74-110), compute-or-load
memoization (:280-372), JSON output signals (:113-277), ``Timer`` and
``logtofile`` (:375-412), and the parameter-encoding cache keys of
``get_datastr_snu`` (stokes_navier_utils.py:21-37).  Arrays go to disk as
host copies: a tensor (on any device) is written through ``numpy``.
"""

import json
import logging
import os
import sys
import time

import numpy as np
import scipy.io
import scipy.sparse as sps
import torch


def get_datastr(time=None, meshp=None, nu=None, Nts=None, data_prfx="",
                semiexpl=False):
    """Parameter-encoding cache keys, format-compatible with the
    reference's ``get_datastr_snu`` (stokes_navier_utils.py:21-37) and the
    JAX package's: all fields always appear (``nuNone``/``NtsNone`` when
    unset), so runs with different meshes or step counts never collide on
    one file."""
    sestr = "_semexp" if semiexpl else ""
    nustr = "_nuNone" if nu is None else "_nu{0:.3e}".format(nu)
    ntsstr = "_NtsNone" if Nts is None else "_Nts{0}".format(Nts)
    timstr = ("timeNone" if time is None or isinstance(time, str)
              else "time{0:.5e}".format(time))
    mshstr = "_mesh{0}".format(meshp)
    return data_prfx + timstr + nustr + mshstr + ntsstr + sestr


def host(x):
    """A host (numpy) copy of a tensor on any device; anything else as
    ``np.asarray`` gives it."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- array persistence ---------------------------------------------------------

def save_npa(v, fstring="notspecified"):
    np.save(fstring, host(v))


def load_npa(fstring):
    if fstring.endswith(".npy"):
        return np.load(fstring)
    return np.load(fstring + ".npy")


def save_spa(sparray, fstring="notspecified"):
    scipy.io.mmwrite(fstring, sps.coo_matrix(sparray))


def load_spa(fstring):
    if not os.path.exists(fstring) and os.path.exists(fstring + ".mtx"):
        fstring = fstring + ".mtx"
    return sps.csc_matrix(scipy.io.mmread(fstring))


def load_or_comp(filestr=None, comprtn=None, comprtnargs={},
                 arraytype=None, debug=False, verbose=True,
                 itsadict=False, numthings=1):
    """Compute-or-load memoization keyed by filename
    (data_output_utils.py:280-372)."""
    if filestr is None or debug:
        return comprtn(**comprtnargs)
    if not isinstance(filestr, list):
        filestr = [filestr]

    loaders = {"dense": (load_npa, save_npa), "sparse": (load_spa, save_spa)}

    if itsadict:
        try:
            things = []
            for fs in filestr:
                with open(fs) as f:
                    things.append(json.load(f))
            return things[0] if len(things) == 1 else things
        except IOError:
            thing = comprtn(**comprtnargs)
            with open(filestr[0], "w") as f:
                json.dump(thing, f)
            return thing

    load, save = loaders.get(arraytype or "dense", loaders["dense"])
    try:
        things = [load(fs) for fs in filestr]
        if verbose:
            logging.info(f"loaded {filestr}")
    except (IOError, FileNotFoundError, ValueError):
        res = comprtn(**comprtnargs)
        things = list(res) if numthings > 1 else [res]
        for fs, t in zip(filestr, things):
            save(t, fs)
        if verbose:
            logging.info(f"computed and saved {filestr}")
    return things[0] if len(things) == 1 else things


# -- output signals ------------------------------------------------------------

def save_output_json(datadict=None, fstring="unspecified_outputfile",
                     module="dolfin_navier_scipy_tpu_torch.utils.io",
                     plotroutine="plot_outp_sig"):
    """JSON signal dump with self-describing replay instructions
    (data_output_utils.py:202-221)."""
    with open(fstring, mode="w") as jsfile:
        jsfile.write(json.dumps(dict(datadict=datadict, module=module,
                                     plotroutine=plotroutine)))
    logging.info(f"output saved to {fstring}; replay with "
                 f"`{module}.{plotroutine}('{fstring}')`")


def extract_output(dictofpaths=None, tmesh=None, c_mat=None, ystarvec=None):
    """``y = C v`` over a stored velocity trajectory
    (data_output_utils.py:224-241)."""
    ylist = [(c_mat @ load_npa(dictofpaths[t]).flatten()).tolist()
             for t in tmesh]
    if ystarvec is None:
        return ylist
    return ylist, [ystarvec(t).flatten().tolist() for t in tmesh]


def meas_output_diff(ylist, tmesh, ystar):
    """Trapezoidal tracking-error integral (data_output_utils.py:244-277)."""
    err = 0.0
    for k in range(1, len(tmesh)):
        dt = tmesh[k] - tmesh[k - 1]
        e0 = np.linalg.norm(np.asarray(ylist[k - 1])
                            - np.asarray(ystar(tmesh[k - 1])).ravel()) ** 2
        e1 = np.linalg.norm(np.asarray(ylist[k])
                            - np.asarray(ystar(tmesh[k])).ravel()) ** 2
        err += 0.5 * dt * (e0 + e1)
    return err


def save_outp_sig_tikz(tmesh, outsig, tikzfile):
    """Write the signal as a standalone pgfplots ``.tex`` picture (the
    reference's tikzplotlib export, data_output_utils.py:134-141, with no
    external dependency)."""
    sig = np.atleast_2d(np.asarray(outsig, dtype=float))
    if sig.shape[0] != len(tmesh):
        sig = sig.T
    lines = ["\\begin{tikzpicture}",
             "\\begin{axis}[xlabel={$t$}]"]
    for j in range(sig.shape[1]):
        coords = " ".join(f"({t:.10g},{y:.10g})"
                          for t, y in zip(tmesh, sig[:, j]))
        lines.append(f"\\addplot coordinates {{{coords}}};")
    lines += ["\\end{axis}", "\\end{tikzpicture}", ""]
    with open(tikzfile, "w") as f:
        f.write("\n".join(lines))
    logging.info(f"tikz picture saved to {tikzfile}")


def plot_outp_sig(str_to_json=None, tmeshkey="tmesh", sigkey="outsig",
                  outsig=None, tmesh=None, fignum=222, tikzfile=None):
    """Plot a stored output signal (data_output_utils.py:113-199);
    matplotlib is imported lazily and optional.  ``tikzfile`` writes a
    pgfplots ``.tex`` export alongside (data_output_utils.py:134-141)."""
    if str_to_json is not None:
        with open(str_to_json) as f:
            jsdict = json.load(f)
        dd = jsdict["datadict"] if "datadict" in jsdict else jsdict
        tmesh = dd[tmeshkey]
        outsig = dd[sigkey]
    if tikzfile is not None:
        save_outp_sig_tikz(tmesh, outsig, tikzfile)
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        logging.warning("matplotlib unavailable; returning data")
        return tmesh, outsig
    plt.figure(fignum)
    plt.plot(tmesh, np.asarray(outsig))
    plt.xlabel("t")
    return tmesh, outsig


# -- timing / logging -----------------------------------------------------------

class Timer:
    """Wall-clock context manager (data_output_utils.py:391-412).

    ``sync``: a callable run at both ends (default: ``torch.cuda.
    synchronize`` when ``device`` is a CUDA device, so the region's time
    includes the card's work; nothing on the CPU).  ``trace_dir``: the
    region is also captured by ``torch.profiler`` (CPU and, on a card,
    CUDA activities) and its Chrome trace written to
    ``trace_dir/<name>.json``.  ``annotate``: the region is a named
    ``torch.profiler.record_function`` range, findable inside an
    enclosing profiler capture."""

    def __init__(self, name="timer", logger=None, timerinfo={}, sync=None,
                 verbose=True, trace_dir=None, annotate=False, device=None):
        self.name = name
        self.logger = logger
        self.timerinfo = timerinfo
        if sync is None and device is not None and \
                torch.device(device).type == "cuda":
            sync = torch.cuda.synchronize
        self.sync = sync
        self.verbose = verbose
        self.trace_dir = trace_dir
        self.annotate = annotate
        self._ann = None
        self._prof = None

    def __enter__(self):
        if self.sync is not None:
            self.sync()
        if self.trace_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        if self.annotate:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.tstart = time.perf_counter()
        return self

    def __exit__(self, *args):
        if self.sync is not None:
            self.sync()
        self.elapsed = time.perf_counter() - self.tstart
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.trace_file = os.path.join(self.trace_dir,
                                           f"{self.name}.json")
            self._prof.export_chrome_trace(self.trace_file)
            logging.info(f"{self.name}: torch.profiler trace written to "
                         f"{self.trace_file}")
        self.timerinfo.update({self.name: self.elapsed})
        msg = f"{self.name}: Elapsed time: {self.elapsed:.6f}s"
        if self.logger is not None:
            self.logger.info(msg)
        elif self.verbose:
            logging.info(msg)


def logtofile(logstr):
    """Redirect stdout to a file (data_output_utils.py:375-388)."""
    print(f"log goes to {logstr}")
    sys.stdout = open(logstr, "a", 1)
