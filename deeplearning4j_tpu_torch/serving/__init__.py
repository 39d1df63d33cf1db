"""Continuous-batching serving (port): gateway → scheduler → pager, and
the load generator that drives them.

Import the classes from their modules (``serving.gateway``,
``serving.scheduler``, ``serving.kv_pager``, ``serving.loadgen``); this
package file imports nothing, so importing one of them stays light.
"""
