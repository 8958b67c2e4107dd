"""Kinds of traffic. A mix under ``bench/traffic/<mix>.json`` is data: its
``kind`` names the module here, ``bench/kinds/<kind>.py``, whose ``Traffic``
class reads the mix's parameters and drives the calls. A new mix of a kind
that exists is one JSON file; a new kind is one module beside these, found
by its name, with no edit to the harness.

A ``Traffic`` is built as ``Traffic(cfg, mix, seed, device, policy)`` and has
``setup()``, ``call(i)`` (a record with ``t0`` and ``t1``, the call's host
clock), ``end_to_end(calls, window_s)``, ``describe(calls)``,
``work(call)``, ``release()`` and ``check(calls, rng)``.
"""
