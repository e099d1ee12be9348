"""The data pipeline of the port: sources, per-sample transforms, batching
(the port's own copy of reverb_tpu/data/, numpy on the host)."""
