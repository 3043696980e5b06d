"""Launchers: so far the model-serve launcher (``model_serve``)."""
