"""The regex transpiler (``transpiler.py``); the reference's span
machinery (``regex/spans.py``) is not ported."""
from spark_rapids_tpu_torch.regex.transpiler import (  # noqa: F401
    CompiledRegex,
    RegexUnsupported,
    compile_regex,
    like_to_regex,
)
