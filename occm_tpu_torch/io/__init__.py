"""Host-side audio and protocol IO: WAV / FLAC decode (`wav`, `flac`),
the native C++ lane built at first use (`native`: threaded batch decode,
header length probes, streaming FLAC), protocol and score files. Callers
take the native lane where `native.available()` and decode in Python
otherwise, with the same waves."""
