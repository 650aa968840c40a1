"""Host-side codecs of the port. So far ``minimsgpack``, the msgpack subset
that the JAX package's converted DINOv3 backbones (flax msgpack files) and
the Blosc2 frame headers are written in."""
