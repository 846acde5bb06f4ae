"""The benchmark's general machinery: finding a cell's files by name
(``spec``), the run's environment and its checks (``guard``), the traffic
loops (``traffic``), the device trace (``devtrace``), the comparison that
decides ``correct`` (``judge``) and one whole run (``cell``)."""
