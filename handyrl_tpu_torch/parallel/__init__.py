"""The data-parallel plane: the torch.distributed job (``multihost``), the
('data', 'model') mesh over its ranks (``mesh``) and the checkpoint layout
manifests (``partition``); the port of ``handyrl_tpu/parallel/``, its
'data' axis (ROADMAP.md section 1 item 5a)."""
