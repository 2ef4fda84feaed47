"""Serving steps of the port; the train step comes with ROADMAP A8."""
