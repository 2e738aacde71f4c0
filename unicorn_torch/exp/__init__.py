"""Experiment configs of the port."""
