"""One reader a per-layer metric, each in the file named after it
(``<metric name>.py``), found by :func:`nuribench.harness.read_metric`."""
