"""The benchmark's own encoders and muxer (frozen copies of the port's),
and one module per codec a configuration names (``sp4``, ``msv1_16``)."""
