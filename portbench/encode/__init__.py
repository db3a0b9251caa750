"""The benchmark's own encoders and muxer (frozen copies of the port's),
one module per codec a configuration names (``sp4``, ``msv1_16``,
``msv1_8``), and one per audio format (``mp3``)."""
