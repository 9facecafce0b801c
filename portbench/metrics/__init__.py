"""Per-layer metrics, one reader a file (``<metric>.py``): ``read(readings)``
returns the metric's value, or None where the run gives it nothing to
read. ``readings`` holds ``config``, ``mix``, ``rounds`` (the window's) and
``trace`` (the traced cycle: ``busy_s``, ``window_s``, ``kernel_s`` by
device function, ``launches`` by kernel entry point, ``flash_shapes``
(attention calls by shape), ``rounds``)."""
