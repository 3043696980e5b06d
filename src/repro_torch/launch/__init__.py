"""Launchers: model serving (``model_serve``), the wire front end
(``serve``), training (``train``), meshes (``mesh``) and the input-spec
stand-ins (``specs``)."""
