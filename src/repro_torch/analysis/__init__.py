"""Static analysis of the int8 serving pipeline: the exact range
certifier (``ranges``) and its check of the committed report
(``certify``)."""
