"""Trainers of the rank classifier and the detector (PyTorch port)."""
