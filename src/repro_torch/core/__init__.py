"""The paper's technique (``repro/core``): MemCom compression."""
