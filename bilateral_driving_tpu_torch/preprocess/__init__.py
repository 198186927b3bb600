"""Offline preprocessing: raw driving logs -> the drivestudio scene layout
that data/scene.py loads (port of bilateral_driving_tpu/preprocess/)."""
