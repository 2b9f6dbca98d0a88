"""Device meshes (``mesh``) and multi-host runs (``distributed``)."""
