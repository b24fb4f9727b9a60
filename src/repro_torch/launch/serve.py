"""Discovery serve loop (the reference's DESIGN.md §9) — the port of
``repro.launch.serve``, on one device: JSONL requests in, JSON responses
out, executed by :class:`repro_torch.service.DiscoveryService`
(round-robin scheduler + result cache) against a registry of demo graphs
(``demo-social`` unlabeled, ``demo-citeseer`` vertex-labeled,
``demo-attributed`` vertex + edge labels).  Label-constrained requests
(DESIGN.md §12) add a ``label_predicate``, e.g.::

    {"graph": "demo-attributed", "workload": "iso", "k": 3,
     "q_edges": [[0, 1], [1, 2], [0, 2]], "q_labels": [1, 1, 1],
     "label_predicate": {"vertex_any_of": [1, 2],
                         "q_any_of": [[1, 2], [1, 2], [1, 2]],
                         "edge_any_of": [0]}}

Durable runs (DESIGN.md §15): requests carrying ``checkpoint_every`` /
``checkpoint_dir`` persist their engine state as they run, and a killed
serve process restarts with ``--resume`` to continue every such request
from its newest committed step — the resumed answers are byte-identical
to an uninterrupted run's.  ``--heartbeat PATH`` touches a liveness file
after every flushed batch so an external supervisor can detect a hung or
killed loop (:class:`repro_torch.runtime.fault_tolerance.Heartbeat`) and
trigger exactly that restart.

Observability (DESIGN.md §16): ``--metrics-dump PATH`` turns on the
process-wide metrics registry and rewrites ``PATH`` with a JSON snapshot
(all counters/gauges/histograms plus span-buffer stats) after every
flushed batch — a scrape-friendly sidecar file.  A control line
``{"cmd": "metrics"}`` in the request stream flushes pending requests and
replies inline with the same live snapshot.

The loop runs on ``cuda`` unless ``--device`` names another device (it
raises without a card); ``--device cpu`` runs every kernel's plain
version.  The request schema is the reference's (docs/API.md); a request
with ``interpret`` not null is answered as an error here.  A ``shards: N``
request runs :class:`repro_torch.distributed.ShardedEngine` on the one
device at any N (the reference answers an error when N exceeds its JAX
device count)::

    PYTHONPATH=src python -m repro_torch.launch.serve --requests reqs.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu < reqs.jsonl

Per-workload walkthroughs: docs/WORKLOADS.md.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def make_demo_registry():
    """Demo graphs the discovery loop serves out of the box."""
    from repro_torch.data.synthetic_graphs import (attributed_graph,
                                                   labeled_graph,
                                                   planted_clique_graph)
    from repro_torch.service import GraphRegistry

    registry = GraphRegistry()
    registry.register("demo-social",
                      planted_clique_graph(n=200, m=1200, clique_size=7,
                                           seed=7))
    registry.register("demo-citeseer", labeled_graph(120, 500, 4, seed=11))
    # vertex labels AND edge types: the label-predicate demo target
    # (docs/WORKLOADS.md §labeled variants)
    registry.register("demo-attributed",
                      attributed_graph(150, 700, n_labels=5,
                                       n_edge_labels=2, seed=13))
    return registry


def serve_discovery(lines=None, out=None, slice_steps: int = 1,
                    batch_size: int = 8, resume: bool = False,
                    heartbeat: str = None, metrics_dump: str = None,
                    observability=None, device=None):
    """Minimal request loop: one JSON request per input line, one JSON
    response per output line (order-preserving), every query on
    ``device`` (default ``cuda``; raises when no CUDA device is present and
    ``device`` is not given).

    Requests are grouped into batches of ``batch_size`` and each batch's
    cache misses run concurrently under the round-robin scheduler; repeats
    within and across batches hit the result cache.  ``resume=True``
    (the ``--resume`` restart path) forces every checkpointed request to
    continue from its newest committed step instead of starting over;
    ``heartbeat`` names a liveness file beaten after every flushed batch;
    ``metrics_dump`` names a JSON file rewritten with the live metrics
    snapshot after every flush (``observability`` overrides the registry
    used — by default one is created whenever ``metrics_dump`` is set).
    """
    from repro_torch.service import (DiscoveryRequest, DiscoveryResponse,
                                     DiscoveryService)
    from repro_torch.obs import NOOP, Observability

    obs = observability
    if obs is None:
        obs = Observability() if metrics_dump else NOOP
    svc = DiscoveryService(registry=make_demo_registry(),
                           slice_steps=slice_steps, observability=obs,
                           device=device)
    lines = sys.stdin if lines is None else lines
    out = sys.stdout if out is None else out
    hb = None
    if heartbeat:
        from repro_torch.runtime.fault_tolerance import Heartbeat
        hb = Heartbeat(heartbeat)

    batch = []
    flushed = [0]

    def dump_metrics():
        if metrics_dump:
            tmp = metrics_dump + ".tmp"
            with open(tmp, "w") as f:
                json.dump(obs.snapshot(), f, indent=1)
            os.replace(tmp, metrics_dump)  # readers never see a torn file

    def flush():
        if not batch:
            return
        for resp in svc.serve(batch):
            # flush per line so pipe/socket consumers see responses as
            # they are produced, not when the process exits
            print(resp.to_json(), file=out, flush=True)
        batch.clear()
        flushed[0] += 1
        if hb is not None:
            hb.beat(flushed[0])
        dump_metrics()

    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        d = {}
        try:
            d = json.loads(line)
            if isinstance(d, dict) and "cmd" in d:
                # control request: flush queued work first so the reply
                # reflects every request that preceded it on the stream
                flush()
                if d["cmd"] == "metrics":
                    reply = {"cmd": "metrics", "status": "ok",
                             "enabled": obs.enabled,
                             "snapshot": obs.snapshot()}
                else:
                    reply = {"cmd": d["cmd"], "status": "error",
                             "error": f"unknown cmd: {d['cmd']!r}"}
                print(json.dumps(reply), file=out, flush=True)
                continue
            req = DiscoveryRequest.from_dict(d)
            if resume and req.checkpoint_dir:
                req = dataclasses.replace(req, resume=True)
        except (ValueError, TypeError) as e:
            flush()   # keep responses in request order
            d = d if isinstance(d, dict) else {}
            print(DiscoveryResponse(
                request_id=d.get("request_id"),
                workload=str(d.get("workload", "unknown")),
                status="error", error=str(e)).to_json(),
                file=out, flush=True)
            continue
        batch.append(req)
        if len(batch) >= batch_size:
            flush()
    flush()
    dump_metrics()   # final snapshot even when the tail batch was empty
    return svc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", default=None,
                    help="JSONL request file (default stdin)")
    ap.add_argument("--slice-steps", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--resume", action="store_true",
                    help="continue checkpointed requests from their newest "
                         "committed step (the restart half of a "
                         "kill-and-resume cycle; DESIGN.md §15)")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="liveness file beaten after every flushed batch")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="enable the metrics registry and rewrite PATH "
                         "with a JSON snapshot after every flushed batch "
                         "(DESIGN.md §16)")
    ap.add_argument("--device", default=None,
                    help="device every query runs on (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    lines = open(args.requests) if args.requests else None
    try:
        svc = serve_discovery(lines=lines, slice_steps=args.slice_steps,
                              batch_size=args.batch_size,
                              resume=args.resume, heartbeat=args.heartbeat,
                              metrics_dump=args.metrics_dump,
                              device=args.device)
    finally:
        if lines is not None:
            lines.close()
    print(f"[serve] {svc.requests_served} requests, "
          f"{svc.engine_steps_total} engine steps, "
          f"cache {svc.cache.stats()}", file=sys.stderr)


if __name__ == "__main__":
    main()
