// tpuhive-gpu-probe: native node-telemetry probe of GPU hosts (schema v1).
//
// Emits exactly one JSON line on stdout describing this host:
//   {"v":1,"chips":[...],"procs":{...},"cpu":{...},"mem":{...},
//    "metrics":{...},"sysfs_metrics":{...},"sysfs_status":"...",
//    "restricted":N}
// The schema is defined in tensorhive_tpu_torch/core/monitors/probe.py,
// which also carries an equivalent inline-Python probe — change both
// together.
//
// A card is what the driver lists through NVML (libnvidia-ml.so.1, opened
// with dlopen; the few entry points used are declared below): its index,
// its device node /dev/nvidia<minor number>, its name, and the driver's
// counters, which see any workload (memory used and total, utilization),
// under the schema's "sysfs_metrics" key. A container's /dev may hold other
// cards' nodes, which the driver does not list; without NVML the cards are
// the /dev/nvidia<N> nodes in the order of N, without counters
// (/dev/nvidiactl and /dev/nvidia-uvm are held by every CUDA process and
// name no card). A card's holder PIDs come from a /proc/*/fd scan for links
// to its node (a CUDA context holds its card's node open; NVML's process
// PIDs belong to the host's PID namespace in a container and need not
// match /proc); process owners from /proc/<pid>; CPU and memory from
// /proc/stat and /proc/meminfo; the workload's drop files
// (~/.tpuhive/metrics/*.json) under "metrics".
//
// Flags (each also read from the environment, the flag winning):
//   --metrics-dir DIR  drop files (TPUHIVE_METRICS_DIR; $HOME flips under
//                      sudo, so the monitor passes its own as a flag)
//   --dev-dir DIR      the device nodes (TPUHIVE_DEV_DIR; default /dev)
//   --nvml-lib PATH    the NVML library to open (TPUHIVE_NVML_LIB; default
//                      libnvidia-ml.so.1): tests give a fake one
//
// Build: g++ -O2 -std=c++17 -o tpuhive-gpu-probe probe.cpp -ldl (C++17 and
// POSIX only; tensorhive_tpu_torch/core/monitors/probe.py builds it at
// first use).

#include <dirent.h>
#include <dlfcn.h>
#include <errno.h>
#include <pwd.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

std::string json_escape(const std::string& in) {
  std::string out;
  out.reserve(in.size() + 8);
  for (unsigned char c : in) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
  return out;
}

std::vector<std::string> list_dir(const std::string& path) {
  std::vector<std::string> names;
  DIR* dir = ::opendir(path.c_str());
  if (!dir) return names;
  while (dirent* ent = ::readdir(dir)) {
    if (std::strcmp(ent->d_name, ".") != 0 && std::strcmp(ent->d_name, "..") != 0)
      names.emplace_back(ent->d_name);
  }
  ::closedir(dir);
  std::sort(names.begin(), names.end());
  return names;
}

bool all_digits(const std::string& s) {
  return !s.empty() &&
         std::all_of(s.begin(), s.end(), [](unsigned char c) { return std::isdigit(c); });
}

std::string read_link(const std::string& path) {
  char buf[4096];
  ssize_t n = ::readlink(path.c_str(), buf, sizeof buf - 1);
  if (n < 0) return {};
  buf[n] = '\0';
  return buf;
}

std::string real_path(const std::string& path) {
  char buf[4096];
  if (::realpath(path.c_str(), buf) == nullptr) return path;
  return buf;
}

std::string flag_or_env(const std::string& flag, const char* env,
                        const std::string& fallback) {
  if (!flag.empty()) return flag;
  if (const char* value = std::getenv(env)) {
    if (*value) return value;
  }
  return fallback;
}

std::string g_dev_dir_flag;
std::string g_nvml_lib_flag;

struct Card {
  unsigned index = 0;
  std::string dev;
  std::string name;
  std::string counters;  // a JSON object of the driver's counters, or ""
};

// NVML's structs and return code, as nvml.h declares them
struct NvmlMemory {
  unsigned long long total, free, used;
};
struct NvmlUtilization {
  unsigned int gpu, memory;
};
constexpr int kNvmlSuccess = 0;

// The cards NVML lists, or none when the library or the driver is absent.
std::vector<Card> driver_cards(const std::string& dir) {
  std::vector<Card> cards;
  const std::string lib = flag_or_env(g_nvml_lib_flag, "TPUHIVE_NVML_LIB",
                                      "libnvidia-ml.so.1");
  void* nvml = ::dlopen(lib.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!nvml) return cards;
  auto symbol = [nvml](const char* name) { return ::dlsym(nvml, name); };
  auto init = reinterpret_cast<int (*)()>(symbol("nvmlInit_v2"));
  auto shutdown = reinterpret_cast<int (*)()>(symbol("nvmlShutdown"));
  auto count = reinterpret_cast<int (*)(unsigned*)>(
      symbol("nvmlDeviceGetCount_v2"));
  auto by_index = reinterpret_cast<int (*)(unsigned, void**)>(
      symbol("nvmlDeviceGetHandleByIndex_v2"));
  auto minor = reinterpret_cast<int (*)(void*, unsigned*)>(
      symbol("nvmlDeviceGetMinorNumber"));
  auto name = reinterpret_cast<int (*)(void*, char*, unsigned)>(
      symbol("nvmlDeviceGetName"));
  auto memory = reinterpret_cast<int (*)(void*, NvmlMemory*)>(
      symbol("nvmlDeviceGetMemoryInfo"));
  auto utilization = reinterpret_cast<int (*)(void*, NvmlUtilization*)>(
      symbol("nvmlDeviceGetUtilizationRates"));
  unsigned n = 0;
  if (init && count && by_index && minor && init() == kNvmlSuccess) {
    if (count(&n) != kNvmlSuccess) n = 0;
    for (unsigned i = 0; i < n; ++i) {
      void* device = nullptr;
      unsigned number = 0;
      if (by_index(i, &device) != kNvmlSuccess ||
          minor(device, &number) != kNvmlSuccess)
        continue;
      Card card;
      card.index = i;
      card.dev = dir + "/nvidia" + std::to_string(number);
      char buf[96] = {0};
      if (name && name(device, buf, sizeof buf) == kNvmlSuccess) card.name = buf;
      std::ostringstream obj;
      NvmlMemory mem{};
      if (memory && memory(device, &mem) == kNvmlSuccess)
        obj << "\"hbm_used_bytes\":" << mem.used << ",\"hbm_total_bytes\":"
            << mem.total;
      NvmlUtilization util{};
      if (utilization && utilization(device, &util) == kNvmlSuccess)
        obj << (obj.tellp() > 0 ? "," : "") << "\"duty_cycle_pct\":"
            << util.gpu;
      if (obj.tellp() > 0) card.counters = "{" + obj.str() + "}";
      cards.push_back(card);
    }
    if (shutdown) shutdown();
  }
  ::dlclose(nvml);
  return cards;
}

// The cards: NVML's, else the nodes <dev dir>/nvidia<N> in the order of N.
std::vector<Card> host_cards() {
  const std::string dir = flag_or_env(g_dev_dir_flag, "TPUHIVE_DEV_DIR",
                                      "/dev");
  std::vector<Card> cards = driver_cards(dir);
  if (!cards.empty()) return cards;
  std::vector<std::pair<long, std::string>> found;
  for (const auto& entry : list_dir(dir)) {
    if (entry.rfind("nvidia", 0) == 0 && all_digits(entry.substr(6)))
      found.emplace_back(std::stol(entry.substr(6)), dir + "/" + entry);
  }
  std::sort(found.begin(), found.end());
  for (const auto& [number, dev] : found) {
    Card card;
    card.index = static_cast<unsigned>(cards.size());
    card.dev = dev;
    cards.push_back(card);
  }
  return cards;
}

// pid -> set of chip indexes, found by resolving every /proc/*/fd symlink
// against the device nodes' real paths. /proc/<pid>/fd is readable only
// for same-uid processes unless the probe runs privileged; unreadable
// candidates are counted into *restricted.
std::map<int, std::set<int>> device_holders(const std::vector<Card>& cards,
                                            int* restricted) {
  std::map<std::string, int> dev_index;
  for (const Card& card : cards)
    dev_index[real_path(card.dev)] = static_cast<int>(card.index);
  std::map<int, std::set<int>> holders;
  if (dev_index.empty()) return holders;
  for (const auto& pid_name : list_dir("/proc")) {
    if (!all_digits(pid_name)) continue;
    const std::string fd_dir = "/proc/" + pid_name + "/fd";
    DIR* dir = ::opendir(fd_dir.c_str());
    if (!dir) {
      if (errno == EACCES) ++*restricted;
      continue;
    }
    while (dirent* ent = ::readdir(dir)) {
      if (ent->d_name[0] == '.') continue;
      const std::string target = read_link(fd_dir + "/" + ent->d_name);
      auto it = dev_index.find(target);
      if (it != dev_index.end()) holders[std::stoi(pid_name)].insert(it->second);
    }
    ::closedir(dir);
  }
  return holders;
}

struct ProcInfo {
  std::string user;
  std::string cmd;
};

bool proc_info(int pid, ProcInfo* out) {
  const std::string base = "/proc/" + std::to_string(pid);
  std::ifstream cmdline(base + "/cmdline", std::ios::binary);
  if (!cmdline) return false;
  std::string raw((std::istreambuf_iterator<char>(cmdline)),
                  std::istreambuf_iterator<char>());
  std::replace(raw.begin(), raw.end(), '\0', ' ');
  while (!raw.empty() && raw.back() == ' ') raw.pop_back();
  out->cmd = raw;
  struct stat st {};
  if (::stat(base.c_str(), &st) != 0) return false;
  if (passwd* pw = ::getpwuid(st.st_uid)) {
    out->user = pw->pw_name;
  } else {
    out->user = std::to_string(st.st_uid);
  }
  return true;
}

struct CpuSample {
  long long total = -1, idle = -1;
  int ncpu = 1;
};

CpuSample cpu_sample() {
  CpuSample s;
  std::ifstream stat("/proc/stat");
  std::string label;
  if (stat >> label && label == "cpu") {
    long long v, total = 0, idle = 0;
    int field = 0;
    while (stat.peek() != '\n' && stat >> v) {
      total += v;
      if (field == 3 || field == 4) idle += v;  // idle + iowait
      ++field;
    }
    if (field >= 4) {
      s.total = total;
      s.idle = idle;
    }
  }
  long n = ::sysconf(_SC_NPROCESSORS_ONLN);
  s.ncpu = n > 0 ? static_cast<int>(n) : 1;
  return s;
}

struct MemSample {
  long long total_kb = 0, avail_kb = 0;
};

MemSample mem_sample() {
  MemSample m;
  std::ifstream info("/proc/meminfo");
  std::string key;
  long long value;
  std::string unit;
  long long mem_free = 0;
  bool has_avail = false;
  while (info >> key >> value) {
    std::getline(info, unit);
    if (key == "MemTotal:") m.total_kb = value;
    else if (key == "MemAvailable:") { m.avail_kb = value; has_avail = true; }
    else if (key == "MemFree:") mem_free = value;
  }
  if (!has_avail) m.avail_kb = mem_free;
  return m;
}

// --- runtime-metric drop-files ---------------------------------------------
// Each ~/.tpuhive/metrics/*.json holds {"<chip_index>": {<metrics>}, ...}.
// We split the top level without a full JSON parser (depth/str tracking),
// inject "age_s" into each per-chip object, and merge across files in
// lexicographic order (later files win), matching the Python fallback.

size_t skip_string(const std::string& s, size_t i) {  // i at opening quote
  for (++i; i < s.size(); ++i) {
    if (s[i] == '\\') ++i;
    else if (s[i] == '"') return i + 1;
  }
  return s.size();
}

// Minimal recursive-descent JSON validator. Drop-file content is spliced
// verbatim into this probe's own output, so anything unparseable must be
// rejected here — one corrupt metrics file must not invalidate the whole
// telemetry line (the Python fallback gets this for free from json.load).
bool skip_ws(const std::string& s, size_t& i) {
  while (i < s.size() && std::isspace(static_cast<unsigned char>(s[i]))) ++i;
  return i < s.size();
}

bool valid_value(const std::string& s, size_t& i, int depth);

bool valid_literal(const std::string& s, size_t& i, const char* word) {
  size_t n = std::strlen(word);
  if (s.compare(i, n, word) != 0) return false;
  i += n;
  return true;
}

bool valid_number(const std::string& s, size_t& i) {
  size_t start = i;
  if (i < s.size() && s[i] == '-') ++i;
  while (i < s.size() && (std::isdigit(static_cast<unsigned char>(s[i])) ||
                          s[i] == '.' || s[i] == 'e' || s[i] == 'E' ||
                          s[i] == '+' || s[i] == '-'))
    ++i;
  return i > start;
}

bool valid_string(const std::string& s, size_t& i) {
  if (i >= s.size() || s[i] != '"') return false;
  for (++i; i < s.size(); ++i) {
    if (s[i] == '\\') { ++i; continue; }
    if (s[i] == '"') { ++i; return true; }
  }
  return false;  // unterminated
}

bool valid_container(const std::string& s, size_t& i, int depth, char open, char close) {
  if (depth > 64 || i >= s.size() || s[i] != open) return false;
  ++i;
  if (!skip_ws(s, i)) return false;
  if (s[i] == close) { ++i; return true; }
  while (true) {
    if (open == '{') {
      if (!skip_ws(s, i) || !valid_string(s, i)) return false;
      if (!skip_ws(s, i) || s[i] != ':') return false;
      ++i;
    }
    if (!valid_value(s, i, depth + 1)) return false;
    if (!skip_ws(s, i)) return false;
    if (s[i] == ',') { ++i; continue; }
    if (s[i] == close) { ++i; return true; }
    return false;
  }
}

bool valid_value(const std::string& s, size_t& i, int depth) {
  if (!skip_ws(s, i)) return false;
  switch (s[i]) {
    case '{': return valid_container(s, i, depth, '{', '}');
    case '[': return valid_container(s, i, depth, '[', ']');
    case '"': return valid_string(s, i);
    case 't': return valid_literal(s, i, "true");
    case 'f': return valid_literal(s, i, "false");
    case 'n': return valid_literal(s, i, "null");
    default: return valid_number(s, i);
  }
}

bool valid_json_document(const std::string& s) {
  size_t i = 0;
  if (!valid_value(s, i, 0)) return false;
  skip_ws(s, i);
  return i == s.size();
}

bool split_top_level(const std::string& text,
                     std::vector<std::pair<std::string, std::string>>* out) {
  size_t i = text.find('{');
  if (i == std::string::npos) return false;
  ++i;
  while (i < text.size()) {
    while (i < text.size() && (std::isspace(static_cast<unsigned char>(text[i])) || text[i] == ','))
      ++i;
    if (i >= text.size() || text[i] == '}') return true;
    if (text[i] != '"') return false;
    size_t key_end = skip_string(text, i);
    std::string key = text.substr(i + 1, key_end - i - 2);
    i = key_end;
    while (i < text.size() && (std::isspace(static_cast<unsigned char>(text[i])) || text[i] == ':'))
      ++i;
    size_t value_start = i;
    int depth = 0;
    while (i < text.size()) {
      char c = text[i];
      if (c == '"') { i = skip_string(text, i); continue; }
      if (c == '{' || c == '[') ++depth;
      else if (c == '}' || c == ']') {
        if (depth == 0) break;
        --depth;
        if (depth == 0) { ++i; break; }
      } else if (c == ',' && depth == 0) {
        break;
      }
      ++i;
    }
    out->emplace_back(key, text.substr(value_start, i - value_start));
  }
  return true;
}

// --metrics-dir <path> lets `sudo -n` invocations keep reading the
// monitoring user's drop-files ($HOME flips to root's home under sudo). An argv
// flag instead of an env assignment because default sudoers (no SETENV
// tag) rejects `sudo VAR=... cmd` outright.
std::string g_metrics_dir_override;

std::map<std::string, std::string> runtime_metrics() {
  std::map<std::string, std::string> merged;
  std::string dir;
  if (!g_metrics_dir_override.empty()) {
    dir = g_metrics_dir_override;
  } else if (const char* override_dir = std::getenv("TPUHIVE_METRICS_DIR")) {
    dir = override_dir;
  } else if (const char* home = std::getenv("HOME")) {
    dir = std::string(home) + "/.tpuhive/metrics";
  } else {
    return merged;
  }
  const time_t now = ::time(nullptr);
  for (const auto& name : list_dir(dir)) {
    if (name.size() < 5 || name.substr(name.size() - 5) != ".json") continue;
    const std::string path = dir + "/" + name;
    struct stat st {};
    if (::stat(path.c_str(), &st) != 0) continue;
    std::ifstream fh(path);
    if (!fh) continue;
    std::string text((std::istreambuf_iterator<char>(fh)),
                     std::istreambuf_iterator<char>());
    if (!valid_json_document(text)) continue;  // corrupt/half-written file
    std::vector<std::pair<std::string, std::string>> entries;
    if (!split_top_level(text, &entries)) continue;
    const double age = ::difftime(now, st.st_mtime);
    char age_buf[48];
    std::snprintf(age_buf, sizeof age_buf, "\"age_s\":%.1f", age < 0 ? 0.0 : age);
    for (auto& [key, value] : entries) {
      if (value.empty() || value.front() != '{') continue;  // chip metrics must be objects
      std::string injected = value;
      size_t brace = injected.find('{');
      bool empty_obj = injected.find_first_not_of(" \t\r\n", brace + 1) != std::string::npos &&
                       injected[injected.find_first_not_of(" \t\r\n", brace + 1)] == '}';
      injected.insert(brace + 1, std::string(age_buf) + (empty_obj ? "" : ","));
      merged[key] = injected;
    }
  }
  return merged;
}

}  // namespace

int main(int argc, char** argv) {
  for (int i = 1; i < argc - 1; ++i) {
    const std::string arg = argv[i];
    if (arg == "--metrics-dir") g_metrics_dir_override = argv[i + 1];
    if (arg == "--dev-dir") g_dev_dir_flag = argv[i + 1];
    if (arg == "--nvml-lib") g_nvml_lib_flag = argv[i + 1];
  }
  const auto cards = host_cards();
  int restricted = 0;
  const auto holders = device_holders(cards, &restricted);

  // invert: chip index -> pids
  std::map<int, std::vector<int>> chip_pids;
  std::set<int> all_pids;
  for (const auto& [pid, chips] : holders) {
    for (int chip : chips) chip_pids[chip].push_back(pid);
    all_pids.insert(pid);
  }

  std::ostringstream out;
  out << "{\"v\":1,\"chips\":[";
  for (size_t i = 0; i < cards.size(); ++i) {
    const Card& card = cards[i];
    if (i) out << ',';
    out << "{\"index\":" << card.index << ",\"dev\":\""
        << json_escape(card.dev) << "\",\"name\":\"" << json_escape(card.name)
        << "\",\"pids\":[";
    auto it = chip_pids.find(static_cast<int>(card.index));
    if (it != chip_pids.end()) {
      for (size_t j = 0; j < it->second.size(); ++j) {
        if (j) out << ',';
        out << it->second[j];
      }
    }
    out << "]}";
  }
  out << "],\"procs\":{";
  bool first = true;
  for (int pid : all_pids) {
    ProcInfo info;
    if (!proc_info(pid, &info)) continue;
    if (!first) out << ',';
    first = false;
    out << "\"" << pid << "\":{\"user\":\"" << json_escape(info.user)
        << "\",\"cmd\":\"" << json_escape(info.cmd) << "\"}";
  }
  out << "},\"cpu\":";
  const CpuSample cpu = cpu_sample();
  if (cpu.total >= 0) {
    out << "{\"total\":" << cpu.total << ",\"idle\":" << cpu.idle
        << ",\"ncpu\":" << cpu.ncpu << "}";
  } else {
    out << "{}";
  }
  const MemSample mem = mem_sample();
  out << ",\"mem\":{\"total_kb\":" << mem.total_kb << ",\"avail_kb\":"
      << mem.avail_kb << "}";
  out << ",\"metrics\":{";
  first = true;
  for (const auto& [key, value] : runtime_metrics()) {
    if (!first) out << ',';
    first = false;
    out << "\"" << json_escape(key) << "\":" << value;
  }
  out << "},\"sysfs_metrics\":{";
  first = true;
  for (const Card& card : cards) {
    if (card.counters.empty()) continue;
    if (!first) out << ',';
    first = false;
    out << "\"" << card.index << "\":" << card.counters;
  }
  out << "},\"sysfs_status\":\"" << (first ? "absent" : "ok") << "\"";
  out << ",\"restricted\":" << restricted << "}";
  std::puts(out.str().c_str());
  return 0;
}
