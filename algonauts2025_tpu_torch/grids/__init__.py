"""Experiment configurations of the port: the default recipe and the smoke run."""
