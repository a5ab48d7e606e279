"""Analysis tools of the port: the runtime concurrency sanitizer
(:mod:`.sanitizer`, ``HANDYRL_TPU_SANITIZE=1``)."""
