"""Training-loop resilience (port of ``sheeprl_tpu/resilience``, one
process): commit manifests (``manifest``), the background checkpoint writer
(``async_writer``), the non-finite sentinel (``sentinel``), the preemption
watcher (``preemption``), ``checkpoint.resume_from=auto``
(``autoresume``) and the loop's facade ``RunResilience`` (``manager``)."""
