"""Serving: the bucketed SLO engine over compiled overlay programs."""
