"""Plain NumPy references of what the benchmark's cells run: the
W-TinyLFU trace replay (``wtinylfu``) and the TinyLFU admission filter
(``tinylfu``), over the 32-bit-lane hash family (``hashing``).  They import
nothing of the program and nothing of JAX."""
