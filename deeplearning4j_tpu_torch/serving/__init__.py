"""Continuous-batching serving (port): gateway → scheduler → pager.

Import the classes from their modules (``serving.gateway``,
``serving.scheduler``, ``serving.kv_pager``); this package file imports
nothing, so importing one of them stays light.
"""
