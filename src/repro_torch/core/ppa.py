"""DSE sampling ranges (copy of ``repro.core.ppa.HW_RANGES``; Sec. 3.3:
"vary global buffer size, #PE per row and column, bit precision, PE
type, and individual scratchpad sizes").  The polynomial PPA models are
not ported yet."""

HW_RANGES = {
    "pe_rows": (8, 10, 12, 14, 16, 20, 24, 28, 32),
    "pe_cols": (8, 10, 12, 14, 16, 20, 24, 28, 32),
    "sp_if": (6, 8, 12, 16, 24, 32, 48, 64),
    "sp_fw": (64, 96, 128, 160, 224, 288, 352, 448),
    "sp_ps": (8, 12, 16, 24, 32, 48, 64),
    "gbuf_kb": (64, 96, 128, 192, 256, 384, 512),
    "bandwidth_gbps": (6.4, 12.8, 25.6),
}
