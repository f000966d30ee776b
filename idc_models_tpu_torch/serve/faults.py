"""The serve loop's injected-failure exceptions, the counterpart of the
two classes of ``idc_models_tpu/serve/faults.py`` the scheduler and the
``serve`` verb name. The declarative fault plan that raises them
(``ServeFaultPlan``, ``--serve-faults``) comes with ROADMAP A9.4."""

from __future__ import annotations


class InjectedEngineCrash(RuntimeError):
    """A declarative `crash` fault firing: the whole engine dies
    mid-run. In-flight entries are failed through the scheduler's
    normal engine-failure cleanup before this propagates."""


class InjectedPrefillError(RuntimeError):
    """A declarative `prefill_error` fault firing: one prefill-chunk
    dispatch dies. Request-scoped -- with a retry policy armed the
    scheduler quarantines only the prefilling request."""
