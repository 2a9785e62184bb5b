"""Serving: the bucketed SLO engine over compiled overlay programs,
pipelined and robust, and the Poisson trace replays that load it."""
