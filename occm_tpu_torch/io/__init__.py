"""Host-side audio and protocol IO: WAV / FLAC decode (`wav`, `flac`),
the native C++ lane built at first use (`native`: threaded batch decode,
header length probes, streaming FLAC), protocol and score files. Callers
take the native lane where `native.available()` and decode in Python
otherwise, with the same waves. The formats of the JAX package's orbax
checkpoints: `zstd` (the system's libzstd), `ocdbt` (the key-value
store) and `zarr` (v2 arrays over it), read by `train.orbax`."""
