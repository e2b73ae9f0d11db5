"""Error reasons and exceptions.

Mirrors the reference error contract (basic_dsp checks_and_results.rs:3-65):
a typed enumeration of failure reasons.  Typed vectors raise `DspError`;
generic (`GenDspVector`) flavors instead *mark the vector as erroneous*
(``valid_len == 0 and delta is NaN``, see vector_types/mod.rs:226-229) so the
storage can be reused without reallocation — this library keeps the same
protocol at the Python level.
"""
from __future__ import annotations

import enum


class ErrorReason(enum.Enum):
    """All error reasons, mirroring reference checks_and_results.rs:3-65."""

    INPUT_MUST_HAVE_THE_SAME_SIZE = "InputMustHaveTheSameSize"
    INPUT_META_DATA_MUST_AGREE = "InputMetaDataMustAgree"
    INPUT_MUST_BE_COMPLEX = "InputMustBeComplex"
    INPUT_MUST_BE_REAL = "InputMustBeReal"
    INPUT_MUST_BE_IN_TIME_DOMAIN = "InputMustBeInTimeDomain"
    INPUT_MUST_BE_IN_FREQUENCY_DOMAIN = "InputMustBeInFrequencyDomain"
    INVALID_ARGUMENT_LENGTH = "InvalidArgumentLength"
    INPUT_MUST_BE_CONJ_SYMMETRIC = "InputMustBeConjSymmetric"
    INPUT_MUST_HAVE_AN_ODD_LENGTH = "InputMustHaveAnOddLength"
    ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC = "ArgumentFunctionMustBeSymmetric"
    INVALID_NUMBER_OF_ARGUMENTS_FOR_COMBINED_OP = (
        "InvalidNumberOfArgumentsForCombinedOp"
    )
    INPUT_MUST_NOT_BE_EMPTY = "InputMustNotBeEmpty"
    INPUT_MUST_HAVE_AN_EVEN_LENGTH = "InputMustHaveAnEvenLength"
    TYPE_CAN_NOT_RESIZE = "TypeCanNotResize"


class DspError(Exception):
    """Exception carrying an :class:`ErrorReason`.

    Raised by statically-typed vector flavors where the reference returns
    ``Err(ErrorReason)``.  The runtime-typed ``GenDspVector`` flavors follow
    the reference's mark-as-erroneous protocol instead of raising.
    """

    def __init__(self, reason: ErrorReason, message: str = ""):
        self.reason = reason
        super().__init__(f"{reason.value}: {message}" if message else reason.value)


class PerformanceError(RuntimeError):
    """Raised instead of a slow-path warning when
    ``DspConfig.fail_on_slow_path`` is set: the op would silently take a
    known slow path (per-sample gather windows in ``interpolatef`` for
    irrational factors).
    Repo-added production guard; the reference has no analog (its CPU
    paths degrade gracefully)."""
