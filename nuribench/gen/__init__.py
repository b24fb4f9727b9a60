"""The inputs' generators: numpy only, so that the reference and the
harness build the same data from a seed without the program.

A configuration's ``generator`` names a file of this folder,
``<generator>.py``, whose ``make(config, seed)`` reads its own size keys
from the configuration and returns the data: ``n`` and ``edges`` (int
``[m, 2]``), and where the configuration has them ``labels`` (``n`` ints,
one a vertex) and ``request`` (fields laid over every request built from
the data, such as ``weights``).  A file draws labels and such fields after
the edges, from a stream of their own seeded by the same seed (such as
``numpy.random.default_rng([seed, 1])``), so that the edges a seed gives
never change.  The frozen functions the files call live in
``graphs.py``."""
