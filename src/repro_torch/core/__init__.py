"""Engine-level modules of the port: hashing geometry (``hashing``), results
(``simulate``) and the device trace simulation driver (``device_simulate``)."""
