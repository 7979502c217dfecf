"""Serving: LM continuous batching over the model zoo and the paged KV
cache whose page tables are PULSE linked lists; and traversal serving
(``traversal_service.PulseService``), the paper's CPU node in front of the
engine, with its admission (``admission``) and its device runner
(``batching.DeviceRunner``)."""
