"""One run of one cell: set-up, the measured window, the check and the
result line.

Everything that belongs to one configuration, traffic mix or metric is
data or a file of its own, found by the name ``BENCHMARK.json`` gives it,
so that a configuration, a cell or a metric arrives as new files and
manifest entries alone:

- a configuration is ``configs/<name>.json`` (the file the manifest names):
  its generator, the sizes that generator reads, the request's fixed
  fields, the module of ``reference/`` that judges its answers, and under
  ``tiny`` the sizes and request fields of the tests' CPU runs (size keys
  at its top level, request fields under its ``request``), which a run
  never reads;
- its generator is ``gen/<generator>.py``, whose ``make(config, seed)``
  returns the data (:func:`make_data`; ``gen/__init__.py`` says what the
  data holds);
- its reference is ``reference/<reference>.py``: ``Reference(n, edges,
  labels=None)`` over the whole data, whose ``judge(fields, response)``
  counts the numbers named in its ``LIMITS`` (:func:`judge`);
- a traffic mix is ``traffic/<name>.json``, read by :func:`make_requests`,
  the one general generator (see its docstring for the keys);
- a metric is ``metrics/<name>.py``, whose ``read(run)`` takes the
  :class:`Run` record and returns a number, or None where it finds nothing
  to read.

A new configuration then needs its config file with ``tiny``, its generator
file (or the name of one there), its reference module (or the name of one
there), a traffic file for each of its cells, and its manifest entries:
its ``configs`` entry, a ``workloads`` entry a cell, and the cells' names
in the ``workloads`` list of each per-layer metric that reads a number in
them.

The window sends the cell's requests to one in-process
``repro_torch.service.DiscoveryService`` through ``serve``, from one client
in a closed loop, until ``seconds`` have passed; the request in flight then
finishes and counts.  Each response is judged afterwards by the plain
reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import signal
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from nuribench import trace as tr

BENCH = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the data graph's handle in the service's registry
HANDLE = "data"
#: seconds past the window's close that an answer is waited for
GRACE_S = 60.0
#: the harness's own numbers compared, with their limits
LIMITS = {"unanswered": 0, "incomplete": 0}
#: seconds at the window's start whose requests a traced run profiles
PROFILED_S = 10.0
#: the scoring kernel's name, every variant (``_mma``, ``_rows``, the tile)
SCORING = "masked_intersect_kernel"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is the program, ``repro`` is not)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------ files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str, root: Path):
    """``(cell, config, traffic)`` of the cell ``name``: its manifest entry,
    its configuration's file and its traffic mix's file."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "nuribench" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` list (if any)
    names the cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, prefix: str):
    """The module of the file ``path``, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(name: str, run: "Run") -> Optional[float]:
    """The value that ``metrics/<name>.py`` reads from ``run``."""
    return _load(BENCH / "metrics" / f"{name}.py",
                 "nuribench_metric_").read(run)


#: what a generator's data may hold
DATA_KEYS = {"n", "edges", "labels", "request"}


def make_data(root: Path, config: dict, seed: int) -> dict:
    """The data of a configuration from ``seed``: what ``make(config,
    seed)`` of ``nuribench/gen/<generator>.py`` under ``root`` returns."""
    data = _load(root / "nuribench" / "gen" / f"{config['generator']}.py",
                 "nuribench_gen_").make(config, seed)
    unknown = set(data) - DATA_KEYS
    if unknown or not {"n", "edges"} <= set(data):
        raise ValueError(f"generator {config['generator']!r} gave the keys "
                         f"{sorted(data)}; data holds n, edges and maybe "
                         f"labels and request")
    return data


# ---------------------------------------------------------------- traffic
def make_requests(config: dict, traffic: dict, trace: bool,
                  overrides: Optional[dict] = None,
                  data: Optional[dict] = None):
    """The warm-up request and a generator of the window's, each a dict of
    ``DiscoveryRequest`` fields, from the configuration and the traffic
    mix.

    The traffic mix's keys:

    - ``loop`` ``"closed"`` and ``clients`` 1: one client sends its next
      request when the last one has answered (the only arrivals so far);
    - ``request``: fields over the configuration's ``request`` and the
      data's (its engine knobs, such as ``steps_per_sync``);
    - ``warmup_step_budget``: the warm-up request's ``step_budget``, or null
      to run it to its end.

    Every request has ``use_cache`` false unless the mix sets it, and
    ``observe`` on in a traced run.  The fields are laid in this order:
    the configuration's ``request``, the ``request`` of the generator's
    ``data`` (such as ``weights``), the mix's ``request``, and on the
    window's requests ``overrides`` (the control's cut ``step_budget``)."""
    if traffic.get("loop", "closed") != "closed" or \
            traffic.get("clients", 1) != 1:
        raise ValueError("the harness drives one client in a closed loop")
    base = dict(config["request"], graph=HANDLE, use_cache=False,
                observe=bool(trace))
    base.update((data or {}).get("request", {}))
    base.update(traffic.get("request", {}))
    warm = dict(base, request_id="warmup")
    if traffic.get("warmup_step_budget") is not None:
        warm["step_budget"] = int(traffic["warmup_step_budget"])

    def window():
        i = 0
        while True:
            yield dict(base, **(overrides or {}), request_id=str(i))
            i += 1

    return warm, window()


# -------------------------------------------------------------------- run
@dataclass
class Sent:
    """One request of the window, as the client saw it."""
    fields: dict
    send: float
    recv: Optional[float] = None
    response: Optional[dict] = None

    @property
    def ok(self) -> bool:
        r = self.response
        return r is not None and r["status"] == "ok" and \
            r["terminated"] == "complete"


@dataclass
class Run:
    """What a metric's reader reads: the cell's configuration, the window's
    requests (host clock, ``time.perf_counter`` seconds), the program's
    spans ``(name, start, seconds, thread)`` on that clock, and in a traced
    run on a card the device's side of the window's leading part
    (:class:`trace.DeviceTrace`).

    ``profiled`` counts the window's first requests, those the profiler
    covered: the device's metrics read them; the host's metrics read the
    requests after them, which ran with no profiler."""
    config: dict
    setup_s: float
    start: float
    end: float
    sent: List[Sent]
    spans: list
    device: Optional[tr.DeviceTrace] = None
    profiled: int = 0

    def answered(self, sent: Optional[List[Sent]] = None) -> List[Sent]:
        """The requests of ``sent`` (default: the window's) answered."""
        return [s for s in (self.sent if sent is None else sent)
                if s.recv is not None]

    def device_part(self) -> List[Sent]:
        """The answered requests that the profiler covered."""
        return self.answered(self.sent[:self.profiled])

    def host_part(self) -> List[Sent]:
        """The answered requests that ran with no profiler."""
        return self.answered(self.sent[self.profiled:])

    @staticmethod
    def steps(sent: List[Sent]) -> int:
        return sum(s.response["stats"].get("steps", 0) for s in sent
                   if s.response is not None and s.response.get("stats"))

    def span_s(self, name: str, sent: List[Sent]) -> float:
        """Seconds of the program's spans named ``name`` that start while
        one of ``sent`` is in flight."""
        windows = sorted((s.send, s.recv) for s in sent)
        if not windows:
            return 0.0
        starts = np.array([a for a, _ in windows])
        total = 0.0
        for n, start, dur, _ in self.spans:
            if n != name:
                continue
            i = np.searchsorted(starts, start, side="right") - 1
            if i >= 0 and start < windows[i][1]:
                total += dur
        return total


class Deadline(Exception):
    """The window's answers did not all come in time."""


def _alarm(signum, frame):
    raise Deadline


class Profiler:
    """``torch.profiler`` over the device's activity alone (kernels, copies,
    sets: no host operation is recorded, so the host runs as it would
    untraced, up to the tracing of its CUDA calls), started before the
    window and stopped after its leading part.  Its clock is put on
    ``perf_counter`` by a marker kernel launched at a known time on an
    idle device (:func:`trace.read_profile`)."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = time.perf_counter()
        torch.cuda._sleep(tr.MARK_CYCLES)
        torch.cuda.synchronize()

    def stop(self, start: float, log) -> tr.DeviceTrace:
        self.torch.cuda.synchronize()
        end = time.perf_counter()
        self.prof.stop()
        stopped = time.perf_counter()
        trace = tr.read_profile(self.prof, self.mark, start, end)
        log(f"profiler: stop {stopped - end:.3f} s, read "
            f"{time.perf_counter() - stopped:.3f} s, after {end - start:.3f}"
            f" s profiled")
        return trace


def run_cell(root: Path, manifest: dict, name: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             overrides: Optional[dict] = None, grace: float = GRACE_S,
             log=None) -> dict:
    """Run the cell once; returns the result line's object.  ``log`` (a
    callable taking a line) gets what the result line may not hold.

    A traced run on a card profiles the device for the requests sent in
    the window's first :data:`PROFILED_S` seconds; the window then runs on
    unprofiled to its close, and at least one request more."""
    import torch
    from repro_torch.core.graph import GraphStore
    from repro_torch.obs import Observability
    from repro_torch.service import DiscoveryRequest, DiscoveryService

    log = log or (lambda line: print(line, file=sys.stderr))
    t0 = time.perf_counter() if t_start is None else t_start
    log(f"imports {time.perf_counter() - t0:.3f} s")
    seed = int(seed) % 2 ** 63
    _, config, traffic = find_cell(manifest, name, root)
    steps_t = {}
    if device == "cuda":
        from repro_torch.kernels import build
        t = time.perf_counter()
        report = build.build_all(["masked_intersect"])["masked_intersect"]
        log(f"kernel build: {'miss' if report['seconds'] else 'hit'} "
            f"(nvcc {report['seconds']:.3f} s, {time.perf_counter() - t:.3f}"
            f" s with the load) in {build.BUILD_DIR}")
    t = time.perf_counter()
    data = make_data(root, config, seed)
    labels = data.get("labels")
    # the program gets its own copy: the reference reads the data's
    store = GraphStore.from_edges(
        data["n"], data["edges"],
        labels=None if labels is None else np.array(labels))
    steps_t["graph"] = time.perf_counter() - t
    obs = Observability(max_spans=1 << 21) if trace else None
    service = DiscoveryService(observability=obs, device=device)
    service.register_graph(HANDLE, store)
    warm, window = make_requests(config, traffic, trace, overrides, data)

    def serve(fields: dict) -> dict:
        req = DiscoveryRequest.from_dict(fields)
        return service.serve([req])[0].to_dict()

    t = time.perf_counter()
    r = serve(warm)
    log(f"warm-up: {r['status']} {r['terminated']} steps "
        f"{r['stats'].get('steps')} in {time.perf_counter() - t:.3f} s")
    if device == "cuda":
        torch.cuda.synchronize()
    steps_t["warmup"] = time.perf_counter() - t
    if obs is not None:
        obs.tracer.clear()
    gc.collect()        # the window starts from the same heap in every run

    setup_s = time.perf_counter() - t0
    prof = Profiler(torch) if trace and device == "cuda" else None
    sent: List[Sent] = []
    profiled = 0
    device_trace = None
    start = time.perf_counter()
    close = start + seconds
    lead = start + min(seconds, PROFILED_S)
    old = signal.signal(signal.SIGALRM, _alarm)
    try:
        while True:
            if prof is not None and time.perf_counter() >= lead:
                device_trace = prof.stop(start, log)
                prof, profiled = None, len(sent)
            t_send = time.perf_counter()
            if t_send >= close and prof is None and \
                    (not trace or len(sent) > profiled):
                break
            call = Sent(next(window), t_send)
            sent.append(call)
            # an answer is waited for until `grace` past the close
            signal.setitimer(signal.ITIMER_REAL,
                             max(close, t_send) + grace - t_send)
            response = serve(call.fields)
            signal.setitimer(signal.ITIMER_REAL, 0)
            call.recv, call.response = time.perf_counter(), response
    except Deadline:
        log(f"window: no answer {grace:.0f} s after the close")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    if prof is not None:        # the window ended in its profiled part
        device_trace = prof.stop(start, log)
        profiled = len(sent)
    end = max((s.recv for s in sent if s.recv is not None), default=start)

    spans = obs.tracer.spans() if obs is not None else []
    run = Run(config=config, setup_s=setup_s, start=start, end=end,
              sent=sent, spans=spans, device=device_trace,
              profiled=profiled)
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else device),
               count=1,
               memory_peak_bytes=(int(torch.cuda.max_memory_allocated(0))
                                  if device == "cuda" else 0))
    if run.device is not None:
        dev.update(busy_s=run.device.busy_s, window_s=run.device.window_s)
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in steps_t.items()))
    log(f"window {end - start:.3f} s, {len(sent)} requests ({profiled} "
        f"profiled); peak device memory {dev['memory_peak_bytes']} B")
    stats = [(s.response or {}).get("stats", {}) for s in sent]
    for key in ("steps", "candidates", "expanded", "spilled", "refilled",
                "late_pruned"):
        log(f"{key} per request: {[st.get(key) for st in stats]}")
    log("latency per request (s): " + str(
        [round(s.recv - s.send, 4) for s in run.answered()]))
    if trace:
        _log_parts(run, log)

    metrics = {}
    for m in metrics_of(manifest, name, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    breakdown = None
    if run.device is not None:
        host = [(n, a, a + d) for n, a, d, _ in spans]
        host += [("service (outside its spans)", s.send, s.recv)
                 for s in run.device_part()]
        idle = tr.idle_by_host(run.device, host)
        breakdown = dict(device_ops=tr.top(tr.by_short_name(
            run.device.seconds_by_name())),
                         idle_gaps=tr.top(idle))

    # the program's state goes before the reference runs
    del service, store, obs, window
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    checks = judge(config, data, sent, log)
    result = dict(correct=all(c["value"] <= c["limit"]
                              for c in checks.values()),
                  attempted=len(sent),
                  failed=sum(not s.ok for s in sent),
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _log_parts(run: Run, log) -> None:
    """The host's spans a step in the profiled part and outside it (what
    the profiler still costs the host), and the device's time a step in
    each profiled request (how far a shorter profiled part would read
    alike)."""
    for label, part in (("profiled", run.device_part()),
                        ("unprofiled", run.host_part())):
        steps = run.steps(part)
        if steps:
            log(f"host spans a step, {label} ({len(part)} requests): " +
                ", ".join(f"{n} {1e3 * run.span_s(n, part) / steps:.4f} ms"
                          for n in ("engine.device_compute",
                                    "engine.host_sync", "engine.spill",
                                    "engine.refill")))
    if run.device is None:
        return
    for s in run.device_part():
        part = run.device.part(s.send, s.recv)
        steps = max(1, run.steps([s]))
        log(f"device, request {s.fields['request_id']}: busy "
            f"{1e3 * part.busy_s / steps:.4f} ms a step, scoring "
            f"{1e3 * part.seconds_of(SCORING) / steps:.4f} ms a step, idle "
            f"{100 * (1 - part.busy_s / part.window_s):.3f}%")


# ------------------------------------------------------------------ check
def judge(config: dict, data: dict, sent: List[Sent], log) -> dict:
    """The numbers compared, each with its limit: requests never answered,
    answers not ``ok`` and complete, and what the configuration's
    reference module counts in the answers (``reference/<name>.py``:
    ``Reference(n, edges, labels=None)`` of the generator's ``data``, its
    ``judge(fields, response)`` and its ``LIMITS``).  The data's request
    fields reach the reference in each request's ``fields``."""
    t = time.perf_counter()
    module = importlib.import_module(
        f"nuribench.reference.{config['reference']}")
    ref = module.Reference(data["n"], data["edges"],
                           labels=data.get("labels"))
    counts = dict(unanswered=sum(s.response is None for s in sent),
                  incomplete=sum(s.response is not None and not s.ok
                                 for s in sent))
    counts.update({k: 0 for k in module.LIMITS})
    for s in sent:
        r = s.response
        if r is None or r["status"] != "ok":
            continue
        for k, v in ref.judge(s.fields, r).items():
            counts[k] += v
    log(f"reference: {len(sent)} answers judged in "
        f"{time.perf_counter() - t:.3f} s")
    limits = dict(LIMITS, **module.LIMITS)
    return {k: dict(value=v, limit=limits[k]) for k, v in counts.items()}
