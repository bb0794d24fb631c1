"""MANO hand model: numpy constants (``model``) and torch LBS (``layer``)."""
