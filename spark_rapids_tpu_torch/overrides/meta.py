"""The tagging tree over the CPU plan — port of
``spark_rapids_tpu/overrides/meta.py`` (``ExprMeta``, ``SparkPlanMeta``)
with the rules of ``spark_rapids_tpu/overrides/overrides.py`` for the
expressions and plan nodes the port builds (``EXPRESSIONS``, ``EXECS``).

Every plan node and expression is wrapped in a meta; ``tag_for_tpu``
records the reference's own reasons why a node will not work on the
device: a type its ``TypeSig`` rejects, a nested type the device layout
lacks, ``spark.rapids.sql.exec.<Name>=false`` or
``spark.rapids.sql.expression.<Name>=false``, and the extra checks (a
decimal multiply above 18 digits, an add or subtract past 38 digits, a
decimal divide whose numerator could pass 18 digits, a decimal remainder
or pmod whose rescaled operand could (the port's own check: the
reference's device skips the rescale, ROADMAP R11), a cast outside the
reference's table or a decimal128 cast pair, ``bround`` of a decimal, a
decimal128 hash key, a ``LIKE``, ``ILIKE`` or
``RLIKE`` pattern that is not a literal or that the transpiler rejects
(the tag-time DFA is stashed on the expression), a disabled file format, an
aggregate's input type, ``avg`` or a variance over a decimal above 18
digits, a residual condition on a join that is not inner, a join without
keys that is not a cross join, a right or full outer nested-loop join,
a collect of strings, decimal128 or nested elements, a Hive hash of a
decimal, a timestamp or a nested column, a time format outside
``parse_format``'s subset, a zone that is not a known literal, a
``to_date``/``to_timestamp`` pattern outside the default grammar, an
``extract`` field outside its table, the string -> timestamp cast while
``spark.rapids.sql.castStringToTimestamp.enabled`` is off) and an open
circuit-breaker entry for the node's key
(``resilience/breaker.py::consult_plan``).  A node with a reason stays on the host as a CPU stage (``cpu/oracle.py``);
``explain`` prints the reasons in the reference's words.  What the
reference runs on the device but the port has not ported yet is not a
reason here: the conversion raises ``NotOnGpu`` for it
(``overrides/overrides.py``).  The reference's profile advisor and
host-kernel check are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (ENABLE_CAST_STRING_TO_TIMESTAMP,
                                           TpuConf)
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import complextypes as CT
from spark_rapids_tpu_torch.expr import conditional as CO
from spark_rapids_tpu_torch.expr import datetime as DT
from spark_rapids_tpu_torch.expr import hashexprs as H
from spark_rapids_tpu_torch.expr import mathfuncs as M
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr.base import (Alias, AttributeReference,
                                              BoundReference, Expression,
                                              Literal)
from spark_rapids_tpu_torch.expr.cast import Cast, cast_supported
from spark_rapids_tpu_torch.plan import nodes as PN


#: The expressions the port runs, on the device and in a CPU stage
#: (``cpu/oracle.py`` has a handler for each); by exact type.
PORTED_EXPRS = frozenset({
    BoundReference, Literal, Alias,
    P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
    P.GreaterThanOrEqual, P.And, P.Or, P.Not, P.IsNull, P.IsNotNull,
    P.In, CO.If, CO.CaseWhen,
    CO.Coalesce, CO.Nvl, A.Add, A.Subtract, A.Multiply, Cast,
    CT.GetStructField, CT.CreateNamedStruct,
    S.Length, S.OctetLength, S.BitLength, S.Upper, S.Lower, S.Substring,
    S.StringLeft, S.StringRight, S.Concat, S.StartsWith, S.EndsWith,
    S.Contains, S.StringInstr, S.StringLocate, S.StringTrim,
    S.StringTrimLeft, S.StringTrimRight, S.Like, S.ILike, S.RLike,
    DT.Year, DT.Month, DT.DayOfMonth, DT.DayOfWeek, DT.DayOfYear,
    DT.Quarter, DT.WeekOfYear, DT.LastDay, DT.DateAdd, DT.DateSub,
    DT.DateDiff, DT.AddMonths, DT.MonthsBetween, DT.TruncDate,
    DT.Hour, DT.Minute, DT.Second, DT.UnixTimestamp, DT.NextDay,
    DT.FromUnixTime, DT.DateFormat, DT.FromUTCTimestamp, DT.ToUTCTimestamp,
    DT.ToUnixTimestamp, DT.WeekDay, DT.MakeDate, DT.MakeTimestamp,
    DT.CurrentDate, DT.CurrentTimestamp, DT.LocalTimestamp,
    DT.TimestampSeconds, DT.TimestampMillis, DT.TimestampMicros,
    DT.UnixDate, DT.DateFromUnixDate, DT.UnixSeconds, DT.UnixMillis,
    DT.UnixMicros, DT.ToDate, DT.ToTimestamp, DT.TruncTimestamp,
    DT.TimestampAdd, DT.TimestampDiff, DT.ConvertTimezone, DT.MonthName,
    DT.DayName, DT.DatePart, DT.ParseToDate, DT.ParseToTimestamp,
    DT.Extract, DT.TryToTimestamp,
    A.Divide, A.IntegralDivide, A.Remainder, A.Pmod, A.UnaryMinus, A.Abs,
    A.UnaryPositive, A.BitwiseAnd, A.BitwiseOr, A.BitwiseXor, A.BitwiseNot,
    A.ShiftLeft, A.ShiftRight, A.ShiftRightUnsigned, A.TryAdd,
    A.TrySubtract, A.TryMultiply, A.TryDivide,
    P.EqualNullSafe, P.IsNaN, CO.NaNvl, CO.Greatest, CO.Least, CO.Nvl2,
    CO.NullIf,
    M.Sqrt, M.Exp, M.Log, M.Log10, M.Sin, M.Cos, M.Tan, M.Asin, M.Acos,
    M.Atan, M.Signum, M.Sinh, M.Cosh, M.Tanh, M.Asinh, M.Acosh, M.Atanh,
    M.Cbrt, M.Log2, M.Log1p, M.Expm1, M.Rint, M.Cot, M.Csc, M.Sec,
    M.ToDegrees, M.ToRadians, M.Pow, M.Floor, M.Ceil, M.Round, M.BRound,
    M.Atan2, M.Hypot, M.Logarithm, M.WidthBucket, M.Factorial,
    M.BitwiseCount,
    H.Murmur3Hash, H.XxHash64, H.HiveHash, H.BloomFilterMightContain})

class BaseMeta:
    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.cannot_run_reasons: List[str] = []
        self.child_metas: List[BaseMeta] = []

    def will_not_work_on_tpu(self, reason: str):
        if reason not in self.cannot_run_reasons:
            self.cannot_run_reasons.append(reason)

    @property
    def can_this_run(self) -> bool:
        return not self.cannot_run_reasons

    @property
    def can_run_with_children(self) -> bool:
        return self.can_this_run and all(
            m.can_run_with_children for m in self.child_metas)


class ExprMeta(BaseMeta):
    """Meta for one expression node."""

    def __init__(self, expr: Expression, conf: TpuConf, rule):
        super().__init__(conf)
        self.expr = expr
        self.rule = rule
        self.child_metas = [wrap_expr(c, conf) for c in expr.children]

    @property
    def name(self) -> str:
        return type(self.expr).__name__

    def tag_for_tpu(self):
        for m in self.child_metas:
            m.tag_for_tpu()
        if self.rule is None:
            self.will_not_work_on_tpu(
                f"expression {self.name} is not supported on TPU")
            return
        if not self.conf.is_op_enabled(self.name, "expression"):
            self.will_not_work_on_tpu(
                f"expression {self.name} has been disabled by "
                f"spark.rapids.sql.expression.{self.name}=false")
        sig: T.TypeSig = self.rule.type_sig
        dt = self.expr._dataType
        if dt is not None and not sig.supports(dt):
            self.will_not_work_on_tpu(
                f"expression {self.name} produces an unsupported type: "
                + sig.reason_not_supported(dt))
        for c in self.expr.children:
            cdt = c._dataType
            if cdt is not None and not sig.supports(cdt) \
                    and not isinstance(cdt, T.NullType):
                self.will_not_work_on_tpu(
                    f"expression {self.name} input: "
                    + sig.reason_not_supported(cdt))
        for d in [dt] + [c._dataType for c in self.expr.children]:
            reason = None if d is None else unsupported_nested_reason(d)
            if reason:
                self.will_not_work_on_tpu(f"expression {self.name}: {reason}")
                break
        if self.rule.extra_check is not None:
            self.rule.extra_check(self)

    def all_reasons(self) -> List[str]:
        out = list(self.cannot_run_reasons)
        for m in self.child_metas:
            out.extend(m.all_reasons())
        return out


class SparkPlanMeta(BaseMeta):
    """Meta for one plan node."""

    def __init__(self, plan: PN.SparkPlan, conf: TpuConf, rule):
        super().__init__(conf)
        self.plan = plan
        self.rule = rule
        self.child_metas = [wrap_plan(c, conf) for c in plan.children]
        self.expr_metas: List[ExprMeta] = []

    @property
    def name(self) -> str:
        return type(self.plan).__name__

    def tag_for_tpu(self):
        for m in self.child_metas:
            m.tag_for_tpu()
        if self.rule is None:
            self.will_not_work_on_tpu(
                f"exec {self.name} is not supported on TPU")
            return
        if not self.conf.is_op_enabled(self.name, "exec"):
            self.will_not_work_on_tpu(
                f"exec {self.name} has been disabled by "
                f"spark.rapids.sql.exec.{self.name}=false")
        sig: T.TypeSig = self.rule.type_sig
        for f in self.plan.output.fields:
            if not sig.supports(f.dataType):
                self.will_not_work_on_tpu(
                    f"exec {self.name} output column '{f.name}': "
                    + sig.reason_not_supported(f.dataType))
            else:
                reason = unsupported_nested_reason(f.dataType)
                if reason:
                    self.will_not_work_on_tpu(
                        f"exec {self.name} output column '{f.name}': "
                        + reason)
        self.expr_metas = [wrap_expr(e, self.conf)
                           for e in _exprs_of(self.plan) if e is not None]
        for em in self.expr_metas:
            em.tag_for_tpu()
            if not em.can_run_with_children:
                for r in em.all_reasons():
                    self.will_not_work_on_tpu(r)
        if self.rule.extra_check is not None:
            self.rule.extra_check(self)
        # circuit breaker (resilience/breaker.py): a plan node whose key
        # the breaker holds open is kept off the device until its TTL
        # admits a probe
        from spark_rapids_tpu_torch.resilience.breaker import consult_plan

        reason = consult_plan(self.plan, self.conf)
        if reason:
            from spark_rapids_tpu_torch import perfcounters as PC

            PC.bump("breaker_plan_fallbacks")
            self.will_not_work_on_tpu(reason)

    def explain(self, indent: int = 0, only_fallback: bool = True) -> str:
        lines = []
        pad = "  " * indent
        if self.can_this_run:
            if not only_fallback:
                lines.append(f"{pad}*{self.name} will run on TPU")
        else:
            reasons = "; ".join(self.cannot_run_reasons)
            lines.append(f"{pad}!{self.name} cannot run on TPU because "
                         f"{reasons}")
        for m in self.child_metas:
            sub = m.explain(indent + 1, only_fallback)
            if sub:
                lines.append(sub)
        return "\n".join(l for l in lines if l)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExprRule:
    type_sig: T.TypeSig
    extra_check: Optional[Callable[[ExprMeta], None]] = None


@dataclasses.dataclass
class ExecRule:
    type_sig: T.TypeSig
    extra_check: Optional[Callable[[SparkPlanMeta], None]] = None


_COMMON = (T.BOOLEAN_SIG + T.numeric + T.STRING_SIG + T.DATETIME_SIG
           + T.NULL_SIG)
_COMMON128 = _COMMON + T.DECIMAL_128_SIG.with_max_decimal(18)
_DEC128_FULL = _COMMON + T.DECIMAL_128_SIG
_NUM = T.numeric + T.NULL_SIG
#: numerics with decimals within 18 digits, for the expressions whose
#: device code reads a decimal as one int64: ``T.numeric`` admits 38 (a
#: ``TypeSig`` sum keeps the larger decimal cap, and ``INTEGRAL_SIG``'s is
#: 38), so the reference's device runs them on the limbs of a 38-digit
#: decimal as if they were int64 (ROADMAP R15)
_NUM18 = _NUM.with_max_decimal(18)
_NUM128 = _NUM + T.DECIMAL_128_SIG
_BITS = T.INTEGRAL_SIG + T.NULL_SIG
_ARRAY_SIG = T.TypeSig(frozenset({T.ArrayType}), 18)
_WITH_ARRAYS = _DEC128_FULL + _ARRAY_SIG
_WITH_MAPS = (T.TypeSig(frozenset({T.MapType, T.ArrayType}))
              + T.BOOLEAN_SIG + T.INTEGRAL_SIG + T.FP_SIG
              + T.DATETIME_SIG + T.NULL_SIG)
_STRUCT_SIG = (T.TypeSig(frozenset({T.StructType})) + T.BOOLEAN_SIG
               + T.INTEGRAL_SIG + T.FP_SIG + T.STRING_SIG
               + T.DATETIME_SIG + T.NULL_SIG)
_WITH_NESTED = _WITH_ARRAYS + T.TypeSig(frozenset({T.StructType,
                                                   T.MapType}))

_PRIM_ELEM = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
              T.LongType, T.FloatType, T.DoubleType, T.DateType,
              T.TimestampType)


def unsupported_nested_reason(dt: T.DataType) -> Optional[str]:
    """Why a nested type cannot live in device columns, or None (the
    reference's rule for rules that do not opt in to string arrays or
    struct entries): array elements and map keys and values must be flat
    primitives, struct fields must not nest."""
    if isinstance(dt, T.ArrayType):
        et = dt.elementType
        if isinstance(et, T.DecimalType):
            return None if not et.is_128 else \
                f"{dt.simpleString}: decimal128 array elements"
        if not isinstance(et, _PRIM_ELEM):
            return (f"{dt.simpleString}: array elements must be flat "
                    f"primitives on TPU (array<string> needs a rule that "
                    f"opts in)")
        return None
    if isinstance(dt, T.MapType):
        for part, name in ((dt.keyType, "key"), (dt.valueType, "value")):
            if isinstance(part, T.DecimalType):
                if part.is_128:
                    return f"{dt.simpleString}: decimal128 map {name}s"
            elif not isinstance(part, _PRIM_ELEM):
                return (f"{dt.simpleString}: map {name}s must be flat "
                        f"primitives on TPU")
        return None
    if isinstance(dt, T.StructType):
        for f in dt.fields:
            if isinstance(f.dataType, (T.ArrayType, T.MapType,
                                       T.StructType)):
                return (f"{dt.simpleString}: nested field "
                        f"{f.name} inside a struct")
    return None


def _check_decimal_mult(meta: ExprMeta):
    for side in (meta.expr.left, meta.expr.right):
        dt = side._dataType
        if isinstance(dt, T.DecimalType) and dt.precision > 18:
            meta.will_not_work_on_tpu(
                "decimal multiply with an operand above 18 digits is not "
                "supported on TPU (needs 256-bit intermediates)")


def _check_decimal_div(meta: ExprMeta):
    """Decimal divide computes numerator = l * 10^(s - ls + rs) in int64;
    operands whose numerator can exceed 18 digits fall back (the
    reference's words)."""
    e = meta.expr
    dt = e.dataType
    if not isinstance(dt, T.DecimalType):
        return
    lt, rt = e.left.dataType, e.right.dataType
    shift = dt.scale - lt.scale + rt.scale
    if lt.precision + max(shift, 0) > 18 or rt.precision + max(-shift, 0) > 18:
        meta.will_not_work_on_tpu(
            "decimal divide intermediate exceeds 18 digits "
            "(128-bit division is not implemented on TPU)")


def _check_decimal_rem(meta: ExprMeta):
    """The port's check for a decimal remainder or pmod: both operands
    are rescaled to the result's scale in int64, so one that could pass
    18 digits there stays off the device."""
    e = meta.expr
    dt = e.dataType
    if not isinstance(dt, T.DecimalType):
        return
    for side in (e.left.dataType, e.right.dataType):
        if side.precision + dt.scale - side.scale > 18:
            meta.will_not_work_on_tpu(
                "decimal remainder intermediate exceeds 18 digits "
                "(128-bit remainder is not implemented on TPU)")
            return


def _check_bround(meta: ExprMeta):
    if isinstance(meta.expr.children[0]._dataType, T.DecimalType):
        meta.will_not_work_on_tpu(
            "bround over decimals (HALF_EVEN rescale) is not supported "
            "on TPU")


def _check_decimal_addsub(meta: ExprMeta):
    lt, rt = meta.expr.left._dataType, meta.expr.right._dataType
    if isinstance(lt, T.DecimalType) and isinstance(rt, T.DecimalType):
        s = max(lt.scale, rt.scale)
        p = max(lt.precision - lt.scale, rt.precision - rt.scale) + s + 1
        if p > 38:
            meta.will_not_work_on_tpu(
                "decimal add/subtract result exceeds 38 digits "
                "(precision-loss rescale not implemented on TPU)")


def _is_dec128(dt) -> bool:
    return isinstance(dt, T.DecimalType) and dt.precision > 18


def _cast_kind(t) -> str:
    if isinstance(t, T.DecimalType):
        return "dec"
    if isinstance(t, (T.ByteType, T.ShortType, T.IntegerType, T.LongType)):
        return "int"
    if isinstance(t, (T.FloatType, T.DoubleType)):
        return "fp"
    return "other"


def _check_cast(meta: ExprMeta):
    """The reference's ``_check_cast``: a cast outside the table, the
    decimal128 pairs its limb paths lack, and the string -> timestamp
    cast while ``spark.rapids.sql.castStringToTimestamp.enabled`` is
    off."""
    e = meta.expr
    src = e.child._dataType
    if src is None:
        return
    if not cast_supported(src, e.to):
        meta.will_not_work_on_tpu(
            f"cast from {src.simpleString} to {e.to.simpleString} is not "
            f"supported on TPU")
    if (_is_dec128(src) or _is_dec128(e.to)) and (
            _cast_kind(src), _cast_kind(e.to)) not in {
            ("dec", "dec"), ("int", "dec"), ("dec", "int"), ("dec", "fp")}:
        meta.will_not_work_on_tpu(
            f"cast {src.simpleString} -> {e.to.simpleString} above 18 "
            f"decimal digits is not supported on TPU")
    if isinstance(src, T.StringType) and isinstance(e.to, T.TimestampType) \
            and not meta.conf.get(ENABLE_CAST_STRING_TO_TIMESTAMP):
        meta.will_not_work_on_tpu(
            "string->timestamp cast is disabled "
            "(spark.rapids.sql.castStringToTimestamp.enabled)")


def _check_like(meta: ExprMeta):
    e: S.Like = meta.expr
    pat = e.right
    if not isinstance(pat, Literal):
        meta.will_not_work_on_tpu("LIKE pattern must be a literal")
        return
    ok, compiled = S.try_compile_like(pat.value)
    if not ok:
        meta.will_not_work_on_tpu(
            f"LIKE pattern {pat.value!r} is not supported on TPU "
            f"(transpiler-reject path; see RegexParser analog)")
    elif compiled is not None:
        e._dfa = compiled  # reuse the tag-time compilation at eval


def _check_rlike(meta: ExprMeta):
    """Transpile at tag time; a reject keeps the expression in a CPU stage
    (the reference's transpiler-reject path)."""
    from spark_rapids_tpu_torch.regex import RegexUnsupported, compile_regex

    pat = meta.expr.children[1]
    if not isinstance(pat, Literal) or pat.value is None:
        meta.will_not_work_on_tpu("RLIKE pattern must be a non-null literal")
        return
    try:
        meta.expr._dfa = compile_regex(pat.value)
    except RegexUnsupported as ex:
        meta.will_not_work_on_tpu(str(ex))


def _check_ilike(meta: ExprMeta):
    e = meta.expr
    pat = e.right
    if not isinstance(pat, Literal) or pat.value is None:
        meta.will_not_work_on_tpu(
            "ILIKE pattern must be a non-null literal")
        return
    ok, compiled = S.try_compile_like(str(pat.value).lower())
    if not ok:
        meta.will_not_work_on_tpu(
            "ILIKE pattern shape is not supported on TPU")
    else:
        e._dfa = compiled


def _check_hive_hash(meta: ExprMeta):
    for c in meta.expr.children:
        if isinstance(c.dataType, (T.DecimalType, T.TimestampType,
                                   T.ArrayType, T.MapType, T.StructType)):
            meta.will_not_work_on_tpu(
                f"hive_hash of {c.dataType.simpleString} is not supported "
                f"on TPU")
            break


def _check_literal_children(*ordinals, names="argument"):
    def check(meta: ExprMeta):
        for o in ordinals:
            ch = meta.expr.children[o]
            if not isinstance(ch, Literal) or ch.value is None:
                meta.will_not_work_on_tpu(
                    f"{names} (child {o}) must be a non-null literal on TPU")
    return check


def _check_time_format(meta: ExprMeta):
    """from_unixtime/date_format: a literal pattern of the supported
    token subset."""
    fmt = meta.expr.children[1]
    if not isinstance(fmt, Literal) or fmt.value is None:
        meta.will_not_work_on_tpu("time format must be a non-null literal")
        return
    if DT.parse_format(str(fmt.value)) is None:
        meta.will_not_work_on_tpu(
            f"time format {fmt.value!r} contains unsupported pattern "
            f"letters (supported: yyyy MM dd HH mm ss + separators)")


def _check_timezone(meta: ExprMeta):
    from spark_rapids_tpu_torch.tzdb import is_known_zone

    tz = meta.expr.children[1]
    if not isinstance(tz, Literal):
        meta.will_not_work_on_tpu(
            "from/to_utc_timestamp: timezone must be a literal")
        return
    if not is_known_zone(tz.value):
        meta.will_not_work_on_tpu(
            f"unknown or unsupported timezone {tz.value!r}")


def _check_convert_timezone(meta: ExprMeta):
    from spark_rapids_tpu_torch.tzdb import is_known_zone

    e = meta.expr
    for tz in (e.source_tz, e.target_tz):
        if not is_known_zone(tz):
            meta.will_not_work_on_tpu(f"unknown timezone {tz!r}")


def _check_literal_fmt(meta: ExprMeta):
    if not isinstance(meta.expr.children[0], Literal) \
            or meta.expr.children[0].value is None:
        meta.will_not_work_on_tpu("format must be a non-null literal")


#: the formats of ``to_date``/``to_timestamp`` that the civil parser reads
PARSE_FORMATS = ("yyyy-MM-dd", "yyyy-MM-dd HH:mm:ss")


def _check_parse_to_datetime(meta: ExprMeta):
    fmt = meta.expr.fmt_literal
    if fmt is None:
        return
    if fmt is False or fmt not in PARSE_FORMATS:
        meta.will_not_work_on_tpu(
            f"to_date/to_timestamp format {fmt!r} is outside the "
            f"default-grammar subset {PARSE_FORMATS} supported on TPU")


def _check_extract(meta: ExprMeta):
    if getattr(meta.expr, "_delegate", None) is None:
        meta.will_not_work_on_tpu(
            "extract: field must be a literal among "
            + "/".join(sorted(DT._EXTRACT_FIELDS)))


_ASCII_CASE = T.STRING_SIG.with_note(T.StringType,
                                     "ASCII-only case conversion")
_BYTE_BASED = T.STRING_SIG.with_note(T.StringType, "byte-based; ASCII-exact")
_DATE_INT = T.DATETIME_SIG + T.INTEGRAL_SIG
#: date_add, date_sub and datediff do integer arithmetic on the days; the
#: reference's code reads a timestamp's microseconds as days there, so a
#: timestamp input stays off the device (ROADMAP.md, fault R8)
_DAYS_INT = T.TypeSig(frozenset({T.DateType})).with_note(
    T.TimestampType, "date arithmetic takes DATE inputs only") \
    + T.INTEGRAL_SIG

EXPRESSIONS: Dict[Type, ExprRule] = {
    Literal: ExprRule(_WITH_ARRAYS),
    BoundReference: ExprRule(_WITH_ARRAYS + _WITH_MAPS),
    AttributeReference: ExprRule(_WITH_ARRAYS + _WITH_MAPS),
    Alias: ExprRule(_WITH_ARRAYS + _WITH_MAPS
                    + T.TypeSig(frozenset({T.StructType}))),
    A.Add: ExprRule(_NUM128, _check_decimal_addsub),
    A.Subtract: ExprRule(_NUM128, _check_decimal_addsub),
    A.Multiply: ExprRule(_NUM128, _check_decimal_mult),
    A.Divide: ExprRule(_NUM, _check_decimal_div),
    A.TryAdd: ExprRule(_NUM128, _check_decimal_addsub),
    A.TrySubtract: ExprRule(_NUM128, _check_decimal_addsub),
    A.TryMultiply: ExprRule(_NUM128, _check_decimal_mult),
    A.TryDivide: ExprRule(_NUM, _check_decimal_div),
    A.IntegralDivide: ExprRule(_NUM),
    A.Remainder: ExprRule(_NUM18, _check_decimal_rem),
    A.Pmod: ExprRule(_NUM18, _check_decimal_rem),
    A.UnaryMinus: ExprRule(_NUM18),
    A.Abs: ExprRule(_NUM18), A.UnaryPositive: ExprRule(_NUM128),
    A.BitwiseAnd: ExprRule(_BITS), A.BitwiseOr: ExprRule(_BITS),
    A.BitwiseXor: ExprRule(_BITS), A.BitwiseNot: ExprRule(_BITS),
    A.ShiftLeft: ExprRule(_BITS), A.ShiftRight: ExprRule(_BITS),
    A.ShiftRightUnsigned: ExprRule(_BITS),
    P.EqualNullSafe: ExprRule(_DEC128_FULL),
    P.IsNaN: ExprRule(T.FP_SIG + T.BOOLEAN_SIG),
    CO.NaNvl: ExprRule(T.FP_SIG),
    CO.Greatest: ExprRule(_NUM18 + T.STRING_SIG.with_max_decimal(18)),
    CO.Least: ExprRule(_NUM18 + T.STRING_SIG.with_max_decimal(18)),
    CO.Nvl2: ExprRule(_COMMON128), CO.NullIf: ExprRule(_COMMON128),
    M.Pow: ExprRule(_NUM), M.Floor: ExprRule(_NUM18), M.Ceil: ExprRule(_NUM18),
    M.Round: ExprRule(_NUM18), M.BRound: ExprRule(_NUM18, _check_bround),
    M.WidthBucket: ExprRule(_NUM18), M.Factorial: ExprRule(T.INTEGRAL_SIG),
    M.BitwiseCount: ExprRule(T.INTEGRAL_SIG + T.BOOLEAN_SIG),
    P.EqualTo: ExprRule(_DEC128_FULL), P.LessThan: ExprRule(_DEC128_FULL),
    P.LessThanOrEqual: ExprRule(_DEC128_FULL),
    P.GreaterThan: ExprRule(_DEC128_FULL),
    P.GreaterThanOrEqual: ExprRule(_DEC128_FULL),
    P.And: ExprRule(T.BOOLEAN_SIG + T.NULL_SIG),
    P.Or: ExprRule(T.BOOLEAN_SIG + T.NULL_SIG),
    P.Not: ExprRule(T.BOOLEAN_SIG + T.NULL_SIG),
    P.IsNull: ExprRule(_WITH_ARRAYS), P.IsNotNull: ExprRule(_WITH_ARRAYS),
    P.In: ExprRule(_DEC128_FULL),
    CO.If: ExprRule(_COMMON128), CO.CaseWhen: ExprRule(_COMMON128),
    CO.Coalesce: ExprRule(_COMMON128), CO.Nvl: ExprRule(_COMMON128),
    Cast: ExprRule(_DEC128_FULL, _check_cast),
    CT.GetStructField: ExprRule(_STRUCT_SIG + _DEC128_FULL),
    CT.CreateNamedStruct: ExprRule(_STRUCT_SIG + _DEC128_FULL),
    S.Length: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.Upper: ExprRule(_ASCII_CASE), S.Lower: ExprRule(_ASCII_CASE),
    S.Substring: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.Concat: ExprRule(T.STRING_SIG),
    S.StartsWith: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG),
    S.EndsWith: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG),
    S.Contains: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG),
    S.StringTrim: ExprRule(T.STRING_SIG),
    S.StringInstr: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.StringLocate: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.OctetLength: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.BitLength: ExprRule(T.STRING_SIG + T.INTEGRAL_SIG),
    S.StringLeft: ExprRule(_BYTE_BASED + T.INTEGRAL_SIG),
    S.StringRight: ExprRule(_BYTE_BASED + T.INTEGRAL_SIG),
    S.StringTrimLeft: ExprRule(T.STRING_SIG),
    S.StringTrimRight: ExprRule(T.STRING_SIG),
    S.Like: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG, _check_like),
    S.RLike: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG, _check_rlike),
    S.ILike: ExprRule(T.STRING_SIG + T.BOOLEAN_SIG, _check_ilike),
    DT.Year: ExprRule(_DATE_INT), DT.Month: ExprRule(_DATE_INT),
    DT.DayOfMonth: ExprRule(_DATE_INT), DT.DayOfWeek: ExprRule(_DATE_INT),
    DT.DayOfYear: ExprRule(_DATE_INT), DT.Quarter: ExprRule(_DATE_INT),
    DT.LastDay: ExprRule(T.DATETIME_SIG),
    DT.DateAdd: ExprRule(_DAYS_INT), DT.DateSub: ExprRule(_DAYS_INT),
    DT.DateDiff: ExprRule(_DAYS_INT), DT.WeekOfYear: ExprRule(_DATE_INT),
    DT.AddMonths: ExprRule(_DATE_INT),
    DT.MonthsBetween: ExprRule(T.DATETIME_SIG + T.FP_SIG),
    DT.TruncDate: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                           _check_literal_children(
                               1, names="trunc format")),
    DT.Hour: ExprRule(_DATE_INT), DT.Minute: ExprRule(_DATE_INT),
    DT.Second: ExprRule(_DATE_INT), DT.UnixTimestamp: ExprRule(_DATE_INT),
    DT.NextDay: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                         _check_literal_children(1, names="day of week")),
    DT.FromUTCTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                                  _check_timezone),
    DT.ToUTCTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                                _check_timezone),
    DT.FromUnixTime: ExprRule(_DATE_INT + T.STRING_SIG, _check_time_format),
    DT.DateFormat: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                            _check_time_format),
    DT.ToUnixTimestamp: ExprRule(_DATE_INT),
    DT.ToDate: ExprRule(T.DATETIME_SIG + T.STRING_SIG),
    DT.ToTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG),
    DT.WeekDay: ExprRule(_DATE_INT), DT.MakeDate: ExprRule(_DATE_INT),
    DT.MakeTimestamp: ExprRule(_DATE_INT + T.FP_SIG + T.DECIMAL_64_SIG),
    DT.CurrentDate: ExprRule(T.DATETIME_SIG),
    DT.CurrentTimestamp: ExprRule(T.DATETIME_SIG),
    DT.LocalTimestamp: ExprRule(T.DATETIME_SIG),
    DT.TimestampSeconds: ExprRule(_DATE_INT + T.FP_SIG),
    DT.TimestampMillis: ExprRule(_DATE_INT),
    DT.TimestampMicros: ExprRule(_DATE_INT),
    DT.UnixSeconds: ExprRule(_DATE_INT), DT.UnixMillis: ExprRule(_DATE_INT),
    DT.UnixMicros: ExprRule(_DATE_INT), DT.UnixDate: ExprRule(_DATE_INT),
    DT.DateFromUnixDate: ExprRule(_DATE_INT),
    DT.TruncTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                                _check_literal_fmt),
    DT.TimestampAdd: ExprRule(_DATE_INT),
    DT.TimestampDiff: ExprRule(_DATE_INT),
    DT.ConvertTimezone: ExprRule(T.DATETIME_SIG, _check_convert_timezone),
    DT.MonthName: ExprRule(T.DATETIME_SIG + T.STRING_SIG),
    DT.DayName: ExprRule(T.DATETIME_SIG + T.STRING_SIG),
    DT.DatePart: ExprRule(_DATE_INT),
    DT.ParseToDate: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                             _check_parse_to_datetime),
    DT.ParseToTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                                  _check_parse_to_datetime),
    DT.Extract: ExprRule(T.DATETIME_SIG + T.STRING_SIG + T.INTEGRAL_SIG,
                         _check_extract),
    DT.TryToTimestamp: ExprRule(T.DATETIME_SIG + T.STRING_SIG,
                                _check_parse_to_datetime),
    H.Murmur3Hash: ExprRule(_COMMON128),
    H.XxHash64: ExprRule(_COMMON128),
    H.HiveHash: ExprRule(_COMMON, _check_hive_hash),
    H.BloomFilterMightContain: ExprRule(_COMMON128 + _ARRAY_SIG),
}
EXPRESSIONS.update({cls: ExprRule(_NUM) for cls in (
    M.Sqrt, M.Exp, M.Log, M.Log10, M.Sin, M.Cos, M.Tan, M.Asin, M.Acos,
    M.Atan, M.Signum, M.Sinh, M.Cosh, M.Tanh, M.Asinh, M.Acosh, M.Atanh,
    M.Cbrt, M.Log2, M.Log1p, M.Expm1, M.Rint, M.Cot, M.Csc, M.Sec,
    M.ToDegrees, M.ToRadians, M.Atan2, M.Hypot, M.Logarithm)})


def _scan_check(meta: SparkPlanMeta):
    fmt = meta.plan.fmt
    key = {"parquet": "spark.rapids.sql.format.parquet.read.enabled",
           "csv": "spark.rapids.sql.format.csv.read.enabled",
           "json": "spark.rapids.sql.format.json.read.enabled",
           "orc": "spark.rapids.sql.format.orc.read.enabled",
           "avro": "spark.rapids.sql.format.avro.read.enabled"}.get(fmt)
    if key is None:
        meta.will_not_work_on_tpu(f"format {fmt} is not supported on TPU")
    elif str(meta.conf.settings.get(key, "true")).lower() == "false":
        meta.will_not_work_on_tpu(f"{fmt} reads disabled by {key}=false")


def _exchange_check(meta: SparkPlanMeta):
    p = meta.plan.partitioning
    if isinstance(p, PN.HashPartitioning):
        for k in p.keys:
            if _is_dec128(k._dataType):
                meta.will_not_work_on_tpu(
                    "hash partitioning on decimals above 18 digits is not "
                    "supported on TPU (murmur3 big-integer path missing)")


_NUMERIC_AGG_INPUT = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                      T.FloatType, T.DoubleType, T.DecimalType)


#: the aggregate functions the reference's device runs
AGG_FUNCS_SUPPORTED = frozenset(
    {"sum", "count", "count_star", "min", "max", "avg", "first", "last",
     "count_if", "bool_and", "bool_or", "any_value", "collect_list",
     "collect_set", "percentile", "approx_percentile", "median",
     "approx_count_distinct", "bloom_filter_agg"}
    | PN.VARIANCE_FUNCS | PN.HIGHER_MOMENT_FUNCS | PN.COVARIANCE_FUNCS
    | PN.REGR_FUNCS | PN.BIT_AGG_FUNCS)


def _agg_extra_checks(meta: SparkPlanMeta, a) -> None:
    """The reference's per-function input gates, in its words."""
    ct = a.child._dataType if a.child is not None else None
    if a.func in ("count_if", "bool_and", "bool_or") \
            and not isinstance(ct, T.BooleanType):
        meta.will_not_work_on_tpu(f"{a.func} requires a boolean input")
    if a.func in ("skewness", "kurtosis", "percentile", "approx_percentile",
                  "median") and not isinstance(ct, _NUMERIC_AGG_INPUT):
        meta.will_not_work_on_tpu(f"{a.func} requires a numeric input")
    if a.func in PN.COVARIANCE_FUNCS or a.func in PN.REGR_FUNCS:
        c2 = a.child2._dataType if a.child2 is not None else None
        if not all(isinstance(t, _NUMERIC_AGG_INPUT) for t in (ct, c2)):
            meta.will_not_work_on_tpu(f"{a.func} requires numeric inputs")
    if a.func in PN.BIT_AGG_FUNCS and not (ct is not None
                                           and ct.is_integral):
        meta.will_not_work_on_tpu(f"{a.func} requires an integral input")
    if a.func == "median" and _is_dec128(ct):
        meta.will_not_work_on_tpu(
            "median over decimal128 is not supported on TPU")
    if a.func in ("percentile", "approx_percentile"):
        if not a.args or not 0.0 <= float(a.args[0]) <= 1.0:
            meta.will_not_work_on_tpu(
                f"{a.func}: percentage must be a literal in [0, 1]")
        if _is_dec128(ct):
            meta.will_not_work_on_tpu(
                f"{a.func} over decimal128 is not supported on TPU")
    if a.func in ("approx_count_distinct", "bloom_filter_agg"):
        if isinstance(ct, T.DecimalType) and ct.precision > 18:
            meta.will_not_work_on_tpu(
                f"{a.func}: decimal128 inputs are not supported (xxhash64 "
                "big-integer path missing)")
        if isinstance(ct, (T.ArrayType, T.MapType, T.StructType)):
            meta.will_not_work_on_tpu(
                f"{a.func} over nested inputs is not supported on TPU")
    if a.func == "bloom_filter_agg" and (
            len(a.args) != 2 or int(a.args[1]) % 64 != 0
            or not 64 <= int(a.args[1]) <= 1 << 22):
        meta.will_not_work_on_tpu(
            "bloom_filter_agg: num_bits must be a multiple of 64 in "
            "[64, 4194304]")


def _agg_check(meta: SparkPlanMeta):
    """The reference's ``_agg_check`` and ``_agg_extra_checks``: no array
    grouping key and no array input but to a collect, its functions and
    their input types, collect of flat elements only (a string, nested or
    decimal128 element is a CPU stage there), and ``avg`` and the
    variance family over decimals above 18 digits (their 128-bit division
    is not on the reference's device)."""
    plan = meta.plan
    for g in plan.grouping:
        if isinstance(g._dataType, T.ArrayType):
            meta.will_not_work_on_tpu(
                "grouping by an array column is not supported on TPU")
    for a in plan.aggregates:
        ct = a.child._dataType if a.child is not None else None
        if a.func not in ("collect_list", "collect_set") \
                and isinstance(ct, T.ArrayType):
            meta.will_not_work_on_tpu(
                f"{a.func} over an array column is not supported on TPU")
        if a.func not in AGG_FUNCS_SUPPORTED:
            meta.will_not_work_on_tpu(
                f"aggregate function {a.func} is not supported on TPU")
        else:
            _agg_extra_checks(meta, a)
        if a.func in ("collect_list", "collect_set") and ct is not None \
                and (isinstance(ct, (T.StringType, T.ArrayType, T.MapType,
                                     T.StructType)) or _is_dec128(ct)):
            meta.will_not_work_on_tpu(
                f"{a.func} of {ct.simpleString} elements is not "
                f"supported on TPU (primitive elements only)")
        if (a.func == "avg" or a.func in PN.VARIANCE_FUNCS) \
                and _is_dec128(ct):
            meta.will_not_work_on_tpu(
                f"{a.func} over decimals above 18 digits needs 128-bit "
                f"division; not supported on TPU yet")


#: the reference's window sets (``overrides.py:1336-1345``): the functions
#: the device runs, those that ignore the frame, and the widest bounded
#: ROWS frame
WINDOW_FUNCS = frozenset(
    {"row_number", "rank", "dense_rank", "sum", "count", "min", "max",
     "avg", "lead", "lag", "ntile", "percent_rank", "cume_dist",
     "first_value", "last_value", "var_pop", "var_samp", "stddev_pop",
     "stddev_samp"})
WINDOW_RANK_FUNCS = frozenset(
    {"row_number", "rank", "dense_rank", "ntile", "percent_rank",
     "cume_dist", "lead", "lag"})
MAX_BOUNDED_WINDOW = 256


def _window_check(meta: SparkPlanMeta):
    """The reference's ``_window_check``, its rules and words: functions
    outside its set, nested, 128-bit (but for ``count``) and decimal
    ``avg``/variance inputs, string sums and variances, string min/max
    over bounded frames, negative offsets, a ROWS frame wider than 256, a
    RANGE frame without exactly one ORDER BY key of an integral, floating,
    DATE or TIMESTAMP type."""
    plan = meta.plan
    frame = plan.frame
    bounded = isinstance(frame, tuple)
    for f in plan.functions:
        if f.func not in WINDOW_FUNCS:
            meta.will_not_work_on_tpu(
                f"window function {f.func} is not supported on TPU")
            continue
        if f.func in WINDOW_RANK_FUNCS:
            continue
        ct = f.child._dataType if f.child is not None else None
        if isinstance(ct, (T.ArrayType, T.MapType, T.StructType)):
            meta.will_not_work_on_tpu(
                f"{f.func} over nested-typed window inputs is not "
                f"supported on TPU")
        if _is_dec128(ct) and f.func != "count":
            meta.will_not_work_on_tpu(
                f"{f.func} over decimals above 18 digits in a window is "
                f"not supported on TPU")
        if isinstance(ct, T.DecimalType) \
                and (f.func == "avg" or f.func.startswith(("var", "stddev"))):
            meta.will_not_work_on_tpu(
                f"window {f.func} over decimals yields a decimal result "
                f"(needs decimal division); not supported on TPU")
        if isinstance(ct, T.StringType):
            if f.func in ("sum", "avg") or f.func.startswith(
                    ("var", "stddev")):
                meta.will_not_work_on_tpu(
                    f"{f.func} over strings is not valid")
            elif f.func in ("min", "max") and bounded:
                meta.will_not_work_on_tpu(
                    "string min/max over bounded window frames is not "
                    "supported on TPU (running/range/unbounded frames "
                    "only)")
    if bounded:
        kind, a, b = frame
        if a < 0 or b < 0:
            meta.will_not_work_on_tpu(
                "bounded window frame offsets must be non-negative")
        elif kind == "rows" and a + b + 1 > MAX_BOUNDED_WINDOW:
            meta.will_not_work_on_tpu(
                f"bounded window width {a + b + 1} exceeds the TPU unroll "
                f"cap ({MAX_BOUNDED_WINDOW})")
        if kind == "range":
            if len(plan.order_by) != 1:
                meta.will_not_work_on_tpu(
                    "RANGE window frames require exactly one ORDER BY key")
            else:
                ot = plan.order_by[0][0]._dataType
                if not (ot.is_integral or isinstance(
                        ot, (T.FloatType, T.DoubleType, T.DateType,
                             T.TimestampType))):
                    meta.will_not_work_on_tpu(
                        f"RANGE window frames over {ot.simpleString} order "
                        f"keys are not supported on TPU")
    if frame == "range_running" or (bounded and frame[0] == "range"):
        if not plan.order_by:
            meta.will_not_work_on_tpu(
                "RANGE window frames require an ORDER BY")


def _join_check(meta: SparkPlanMeta):
    """The reference's ``_join_check``: every join type runs on the
    device, a residual condition only on an inner join, and a join
    without equi-keys only as a cross join."""
    plan = meta.plan
    if plan.condition is not None and plan.join_type != PN.JoinType.INNER:
        meta.will_not_work_on_tpu(
            "non-inner join with residual condition is not supported on TPU")
    if not plan.left_keys and plan.join_type != PN.JoinType.CROSS:
        meta.will_not_work_on_tpu("equi-join keys required")
    for k in list(plan.left_keys) + list(plan.right_keys):
        if isinstance(k._dataType, (T.ArrayType, T.MapType, T.StructType)):
            meta.will_not_work_on_tpu(
                "join keys of nested types are not supported on TPU")


#: the nested-loop join types the device runs (the reference's)
BNLJ_TYPES = frozenset({PN.JoinType.INNER, PN.JoinType.CROSS,
                        PN.JoinType.LEFT_OUTER, PN.JoinType.LEFT_SEMI,
                        PN.JoinType.LEFT_ANTI})


def _bnlj_check(meta: SparkPlanMeta):
    plan = meta.plan
    if plan.join_type not in BNLJ_TYPES:
        meta.will_not_work_on_tpu(
            f"nested-loop join type {plan.join_type.value} is not supported "
            f"on TPU (use an equi-join)")


def _exprs_of(plan: PN.SparkPlan) -> List[Expression]:
    if isinstance(plan, PN.Project):
        return list(plan.exprs)
    if isinstance(plan, PN.Filter):
        return [plan.condition]
    if isinstance(plan, PN.HashAggregate):
        return list(plan.grouping) + [a.child for a in plan.aggregates
                                      if a.child is not None]
    if isinstance(plan, PN._BaseJoin):
        out = list(plan.left_keys) + list(plan.right_keys)
        return out + ([plan.condition] if plan.condition is not None
                      else [])
    if isinstance(plan, PN.Sort):
        return [e for e, _ in plan.orders]
    if isinstance(plan, PN.Window):
        out = list(plan.partition_by) + [e for e, _ in plan.order_by]
        return out + [f.child for f in plan.functions if f.child is not None]
    if isinstance(plan, PN.Exchange) and isinstance(
            plan.partitioning, PN.HashPartitioning):
        return list(plan.partitioning.keys)
    return []


EXECS: Dict[Type, ExecRule] = {
    PN.LocalTableScan: ExecRule(_WITH_NESTED),
    PN.FileSourceScan: ExecRule(_DEC128_FULL, _scan_check),
    PN.Project: ExecRule(_WITH_NESTED),
    PN.Filter: ExecRule(_WITH_NESTED),
    PN.HashAggregate: ExecRule(_WITH_ARRAYS, _agg_check),
    PN.SortMergeJoin: ExecRule(_WITH_ARRAYS, _join_check),
    PN.ShuffledHashJoin: ExecRule(_WITH_ARRAYS, _join_check),
    PN.BroadcastHashJoin: ExecRule(_WITH_ARRAYS, _join_check),
    PN.BroadcastNestedLoopJoin: ExecRule(_DEC128_FULL, _bnlj_check),
    PN.Sort: ExecRule(_DEC128_FULL),
    PN.Window: ExecRule(_COMMON128, _window_check),
    PN.Exchange: ExecRule(_DEC128_FULL, _exchange_check),
    PN.BroadcastExchange: ExecRule(_DEC128_FULL),
    PN.GlobalLimit: ExecRule(_WITH_ARRAYS),
    PN.LocalLimit: ExecRule(_WITH_ARRAYS),
    PN.Union: ExecRule(_WITH_ARRAYS),
}


def wrap_expr(e: Expression, conf: TpuConf) -> ExprMeta:
    return ExprMeta(e, conf, EXPRESSIONS.get(type(e)))


def wrap_plan(plan: PN.SparkPlan, conf: TpuConf) -> SparkPlanMeta:
    return SparkPlanMeta(plan, conf, EXECS.get(type(plan)))
