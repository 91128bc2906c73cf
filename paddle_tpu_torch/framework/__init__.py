"""Framework pieces of the port: the runtime flag registry (``flags``),
``ParamAttr`` (``param_attr``), the global seed (``random``) and
``save``/``load`` (``io``)."""
