"""The benchmark's general parts: the manifest, the run, the trace."""
