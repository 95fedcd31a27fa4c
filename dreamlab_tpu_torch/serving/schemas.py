"""Request schemas as plain classes (port of ``dreamlab_tpu/serving/schemas.py``).

The JAX package declares these as pydantic models; the port validates them
itself, with the same fields, defaults and bounds and the same lax-mode
coercions as pydantic's validation of a decoded JSON body ("4" and 4.0 are
4, 4.5 is refused, "yes" is True). A failed validation raises
``ValidationError``, whose ``errors()`` are pydantic's entries: the same
``loc``, ``type``, ``msg``, ``input`` and ``ctx`` (no ``url``), so the 422
body is ``{"detail": [...]}`` as the JAX server sends it. Each model keeps
``model_fields_set`` (the names the client gave) and ``model_dump()`` in
field order.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from ..engine.base import parse_size

_MISSING = object()
_INT_RE = re.compile(r"^[+-]?[0-9]+(?:_[0-9]+)*$")
_INT_DOT_ZERO_RE = re.compile(r"^([+-]?[0-9]+(?:_[0-9]+)*)\.0+$")
_I64 = 2**63  # pydantic-core reads a float as an i64
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class _Error(Exception):
    def __init__(self, type_: str, msg: str, ctx: Optional[dict] = None):
        super().__init__(msg)
        self.type, self.msg, self.ctx = type_, msg, ctx


class ValidationError(ValueError):
    """pydantic's ``ValidationError``: one entry per failed field."""

    def __init__(self, title: str, errors: List[dict]):
        self.title = title
        self._errors = errors
        super().__init__(f"{len(errors)} validation error(s) for {title}: "
                         + "; ".join(f"{'.'.join(map(str, e['loc']))}: {e['msg']}"
                                     for e in errors))

    def errors(self) -> List[dict]:
        return [dict(e) for e in self._errors]


def _num(v) -> str:
    """A bound as pydantic prints it: 20.0 as 20, 0.5 as 0.5."""
    return str(int(v)) if float(v).is_integer() else repr(v)


def _bounds(v, ge, le):
    if le is not None and not v <= le:
        raise _Error("less_than_equal", f"Input should be less than or equal to {_num(le)}",
                     {"le": le})
    if ge is not None and not v >= ge:
        raise _Error("greater_than_equal",
                     f"Input should be greater than or equal to {_num(ge)}", {"ge": ge})
    return v


def _as_int(v) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise _Error("finite_number", "Input should be a finite number")
        if not v.is_integer():
            raise _Error("int_from_float",
                         "Input should be a valid integer, got a number with a fractional part")
        if abs(v) >= _I64:
            raise _Error("int_parsing_size",
                         "Unable to parse input string as an integer, exceeded maximum size")
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        m = _INT_DOT_ZERO_RE.match(s)
        if _INT_RE.match(s) or m:
            return int(m.group(1) if m else s)
        raise _Error("int_parsing",
                     "Input should be a valid integer, unable to parse string as an integer")
    raise _Error("int_type", "Input should be a valid integer")


def _as_float(v) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            if not v.isascii():
                raise ValueError(v)
            return float(v.strip())
        except ValueError:
            raise _Error("float_parsing", "Input should be a valid number, unable to parse "
                                          "string as a number") from None
    raise _Error("float_type", "Input should be a valid number")


def _as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, float) and math.isfinite(v) and v.is_integer():
        v = int(v)
    if isinstance(v, int) and abs(v) < _I64:
        if v in (0, 1):
            return bool(v)
        raise _Error("bool_parsing", "Input should be a valid boolean, unable to interpret input")
    if isinstance(v, str):
        low = v.lower()
        if low in _TRUE or low in _FALSE:
            return low in _TRUE
        raise _Error("bool_parsing", "Input should be a valid boolean, unable to interpret input")
    raise _Error("bool_type", "Input should be a valid boolean")


def _as_str(v) -> str:
    if isinstance(v, str):
        return v
    raise _Error("string_type", "Input should be a valid string")


def _as_list(v) -> list:
    if isinstance(v, (list, tuple)):
        return list(v)
    raise _Error("list_type", "Input should be a valid list")


_CAST = {int: _as_int, float: _as_float, bool: _as_bool, str: _as_str, list: _as_list}


class Field:
    """One field: its type (a scalar type, ``list`` or a ``Model``),
    whether None is allowed, its default (``_MISSING``: required), its
    bounds and an optional validator of the coerced value."""

    def __init__(self, kind, default=_MISSING, *, optional: bool = False, ge=None, le=None,
                 check=None):
        self.kind, self.default, self.optional = kind, default, optional
        self.ge, self.le, self.check = ge, le, check

    def validate(self, v, loc: Tuple, errors: List[dict]):
        if v is None and self.optional:
            return None
        try:
            if isinstance(self.kind, type) and issubclass(self.kind, Model):
                return self.kind._validate(v, loc, errors)
            v = _CAST[self.kind](v)
            if self.kind in (int, float):
                _bounds(v, self.ge, self.le)
            if self.check is not None:
                try:
                    v = self.check(v)
                except ValueError as e:
                    raise _Error("value_error", f"Value error, {e}", {"error": str(e)}) from None
            return v
        except _Error as e:
            entry = {"type": e.type, "loc": list(loc), "msg": e.msg, "input": v}
            if e.ctx is not None:
                entry["ctx"] = e.ctx
            errors.append(entry)
            return None


class Model:
    """A schema: ``FIELDS`` maps each name to its ``Field``, in order."""

    FIELDS: Dict[str, Field] = {}

    def __init__(self, **data):
        errors: List[dict] = []
        self._fill(data, (), errors)
        if errors:
            raise ValidationError(type(self).__name__, errors)

    def _fill(self, data: dict, loc: Tuple, errors: List[dict]) -> None:
        self.model_fields_set = {k for k in data if k in self.FIELDS}
        for name, f in self.FIELDS.items():
            if name in data:
                value = f.validate(data[name], loc + (name,), errors)
            elif f.default is _MISSING:
                errors.append({"type": "missing", "loc": list(loc + (name,)),
                               "msg": "Field required", "input": data})
                value = None
            else:
                value = f.default
            setattr(self, name, value)

    @classmethod
    def _validate(cls, data, loc: Tuple, errors: List[dict]):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise _Error("model_type",
                         f"Input should be a valid dictionary or instance of {cls.__name__}",
                         {"class_name": cls.__name__})
        obj = cls.__new__(cls)
        obj._fill(data, loc, errors)
        return obj

    @classmethod
    def model_validate(cls, data):
        errors: List[dict] = []
        try:
            obj = cls._validate(data, (), errors)
        except _Error as e:
            errors.append({"type": e.type, "loc": [], "msg": e.msg, "input": data,
                           "ctx": e.ctx})
            obj = None
        if errors:
            raise ValidationError(cls.__name__, errors)
        return obj

    def model_dump(self) -> Dict[str, Any]:
        out = {}
        for name in self.FIELDS:
            v = getattr(self, name)
            out[name] = v.model_dump() if isinstance(v, Model) else v
        return out

    def __repr__(self):
        return f"{type(self).__name__}({self.model_dump()!r})"


def _check_size(v: str) -> str:
    parse_size(v)  # raises ValueError on a bad format
    return v


def _check_fmt(v: str) -> str:
    if v.lower() not in ("png", "jpeg", "jpg"):
        raise ValueError("superres_format must be png or jpeg")
    return v.lower()


class StyleLoRARequest(Model):
    FIELDS = {
        "style": Field(str, None, optional=True),
        "level": Field(int, 0, ge=0, le=8),
    }


class GenerateRequest(Model):
    """``/generate``'s body: prompt, mode?, size "WxH", 1-50 steps, guidance
    0-20, seed 0..2^31-1?, style_lora {style?, level 0-8}, superres options,
    the refiner's aesthetic score and a ControlNet hint (base64 PNG/JPEG or
    a data URL, resized by the server to the output size)."""

    FIELDS = {
        "prompt": Field(str),
        "mode": Field(str, None, optional=True),
        "size": Field(str, "512x512", check=_check_size),
        "num_inference_steps": Field(int, 4, ge=1, le=50),
        "guidance_scale": Field(float, 1.0, ge=0.0, le=20.0),
        "seed": Field(int, None, optional=True, ge=0, le=2**31 - 1),
        "negative_prompt": Field(str, None, optional=True),
        "style_lora": Field(StyleLoRARequest, None, optional=True),
        "superres": Field(bool, False),
        "superres_format": Field(str, "png", check=_check_fmt),
        "superres_quality": Field(int, 92, ge=1, le=100),
        "superres_magnitude": Field(int, 2, ge=1, le=3),
        "aesthetic_score": Field(float, None, optional=True, ge=0.0, le=10.0),
        "control_image": Field(str, None, optional=True),
        "controlnet_scale": Field(float, None, optional=True, ge=0.0, le=2.0),
    }


class A1111Txt2ImgRequest(Model):
    """AUTOMATIC1111 ``/sdapi/v1/txt2img`` subset (seed -1: random)."""

    FIELDS = {
        "prompt": Field(str, ""),
        "negative_prompt": Field(str, None, optional=True),
        "steps": Field(int, 4, ge=1, le=50),
        "cfg_scale": Field(float, 1.0, ge=0.0, le=20.0),
        "width": Field(int, 512),
        "height": Field(int, 512),
        "seed": Field(int, -1),
        "batch_size": Field(int, 1, ge=1, le=8),
        "sampler_name": Field(str, None, optional=True),
        "styles": Field(list, None, optional=True),
    }


class OpenAIImagesRequest(Model):
    """OpenAI Images ``/v1/images/generations`` subset."""

    FIELDS = {
        "prompt": Field(str),
        "n": Field(int, 1, ge=1, le=8),
        "size": Field(str, "512x512"),
        "response_format": Field(str, "b64_json"),
        "model": Field(str, None, optional=True),
        "user": Field(str, None, optional=True),
    }
