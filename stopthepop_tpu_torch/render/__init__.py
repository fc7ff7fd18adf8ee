"""Render pipeline stages: preprocess, pairs, blend, API, CLI."""
