"""One driver a kind of configuration (its ``system``): a ``Session`` that
sets the cell up from the seed, runs one unit of the window (a replay, a
request), and compares what the window produced with the reference."""
