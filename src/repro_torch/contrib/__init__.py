"""Out-of-core algorithm plugins built purely on the ``repro_torch.fl.api``
hook interface (port of ``repro/contrib``): nothing here is imported by
``repro_torch.core`` / ``repro_torch.engine``; each module registers itself
with :func:`repro_torch.fl.api.register_algorithm` exactly the way a
third-party package would."""
