"""I/O (port of ``hikari_tpu.io``): the built-in scene configs
(``scenes``), PNG output and image metrics (``image``) and the frame-state
checkpoint (``checkpoint``)."""
