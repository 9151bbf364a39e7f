"""The harness: what every traffic kind shares, the serving loop, the dense
decoder's side of a run, the yardstick, the trace reader and the comparison
that decides ``correct``."""
