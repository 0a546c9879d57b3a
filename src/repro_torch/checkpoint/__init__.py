"""Checkpoints of the port: the reference's on-disk format (a manifest and
one ``.npy`` file per leaf, written atomically), for trees of torch tensors
and numpy arrays (``store``)."""
