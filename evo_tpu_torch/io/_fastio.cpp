// Native FASTA scanner (data-loader hot path).
//
// One pass over the raw file buffer: records header spans and writes the
// whitespace-stripped sequence bytes into a caller-provided output buffer,
// recording per-record end offsets. Python (ctypes) slices names from the
// original buffer and sequences from the packed output — no per-line
// Python work, which is what makes genome-scale FASTA loading fast.
//
// Build: g++ -O3 -shared -fPIC -o _fastio.so _fastio.cpp
// (driven at first use by evo_tpu_torch/io/fastio.py, into
// evo_tpu_torch/build/)

#include <cstddef>
#include <cstdint>

extern "C" {

// Returns the number of records parsed, or -1 if max_records would be
// exceeded. Outputs:
//   out_seq        packed sequence bytes (size >= n)
//   name_starts/name_ends   header spans in `buf` (without '>')
//   seq_ends       exclusive end offset of each record's bytes in out_seq
long fastio_scan(const char* buf, long n, char* out_seq,
                 long* name_starts, long* name_ends, long* seq_ends,
                 long max_records) {
    long num = 0;
    long out = 0;
    long i = 0;
    bool in_record = false;
    bool at_line_start = true;
    while (i < n) {
        char c = buf[i];
        // '>' opens a record only at line start (parity with the Python
        // parser and with fastio_count_records' sizing pass; a mid-line
        // '>' is sequence content)
        if (c == '>' && at_line_start) {
            if (in_record) {
                seq_ends[num - 1] = out;
            }
            if (num >= max_records) return -1;
            long start = ++i;
            while (i < n && buf[i] != '\n' && buf[i] != '\r') i++;
            name_starts[num] = start;
            name_ends[num] = i;
            num++;
            in_record = true;
            // skip line terminator(s)
            while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
            at_line_start = true;
        } else if (in_record) {
            // copy one sequence line: strip leading/trailing blanks
            // (parity with the Python parser's per-line strip) but keep
            // interior spaces (EOS-token semantics depend on them)
            while (i < n && (buf[i] == ' ' || buf[i] == '\t')) i++;
            long line_out_start = out;
            long last_non_blank = out;
            while (i < n && buf[i] != '\n' && buf[i] != '\r') {
                char b = buf[i++];
                out_seq[out++] = b;
                if (b != ' ' && b != '\t') last_non_blank = out;
            }
            out = (last_non_blank > line_out_start) ? last_non_blank
                                                    : line_out_start;
            while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
            at_line_start = true;
        } else {
            at_line_start = (buf[i] == '\n');
            i++;  // leading junk before the first '>'
        }
    }
    if (in_record) seq_ends[num - 1] = out;
    return num;
}

// Count '>' characters at line starts (record count) for buffer sizing.
long fastio_count_records(const char* buf, long n) {
    long count = 0;
    bool at_line_start = true;
    for (long i = 0; i < n; i++) {
        if (at_line_start && buf[i] == '>') count++;
        at_line_start = (buf[i] == '\n');
    }
    return count;
}

}  // extern "C"
