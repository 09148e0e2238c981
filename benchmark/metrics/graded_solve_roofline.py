"""``graded_solve_roofline``: ``solve_roofline``'s arithmetic, read in the
graded cell (``solve_roofline`` keeps the list of cells it was accepted
with): the share (%) of the solve spans' device time that the least time
of their work takes, over the whole profiled requests.  The work is
``cost.solve_cost``, counted by nonzero entries, so the empty slots of a
widened transfer window add none.  Nothing where no whole profiled request
has its solve stage attributed."""

from benchmark.metrics.solve_roofline import read  # noqa: F401
